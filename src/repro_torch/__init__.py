"""PyTorch/CUDA port of the Spike-IAND-Former deploy path.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module (``core``, ``engine``, ``kernels``, ``configs``,
``launch``) and imports nothing of it.  Every TPU (Pallas) kernel on the
ported path has a hand-written CUDA C++ counterpart under
``kernels/*/csrc``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`).  Entry points run on the card unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper takes its
plain PyTorch version.
"""
