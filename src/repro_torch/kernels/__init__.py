"""Hand-written CUDA C++ kernels for the H100 (``sm_90a``), one per TPU kernel
of the ported paths, each beside its plain PyTorch version:

lif_parallel      -- unrolled reconfigurable multi-time-step LIF (+ fused IAND),
                     with dense f32 spikes out or spikes packed into words
spike_matmul      -- T-folded spike x weight GEMM (im2col 3x3 / 1x1 / matmul),
                     on dense spikes or on packed spike words
spiking_attention -- tick-batched softmax-free binary (Q K^T) V, on dense
                     spikes or on packed spike words

``_build`` compiles ``*/csrc/*.cu`` with ``nvcc`` at first use.
"""
