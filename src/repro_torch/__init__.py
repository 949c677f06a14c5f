"""PyTorch/CUDA port of ``repro``: binarized-LM serving on the packed
XNOR+popcount engine, with hand-written CUDA kernels for Hopper, and
training with the straight-through estimator.

The package mirrors ``repro``'s module layout (``core``, ``kernels``,
``models``, ``configs``, ``compiler``, ``serving``, ``fleet``,
``faults``, ``mapping``, ``obs``, ``optim``, ``data``, ``checkpoint``,
``train``, ``launch``) and
imports only ``torch``, numpy and the standard library. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).
"""
