"""T-folded spike x weight GEMM kernel (linear, 1x1 and im2col 3x3 conv)."""
