"""Hand-written CUDA C++ kernels for the H100 (``sm_90a``), one per TPU kernel
of the ported path, each beside its plain PyTorch version:

lif_parallel      -- unrolled reconfigurable multi-time-step LIF (+ fused IAND)
spike_matmul      -- T-folded spike x weight GEMM (im2col 3x3 / 1x1 / matmul)
spiking_attention -- tick-batched softmax-free binary (Q K^T) V

``_build`` compiles ``*/csrc/*.cu`` with ``nvcc`` at first use.
"""
