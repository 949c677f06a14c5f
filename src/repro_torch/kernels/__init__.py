"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
and the ops wrappers. Kernels build with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`); importing this package builds
nothing."""
