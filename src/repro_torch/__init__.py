"""PyTorch/CUDA port of ``repro``: binarized-LM serving on the packed
XNOR+popcount engine, with hand-written CUDA kernels for Hopper.

The package mirrors ``repro``'s module layout (``core``, ``kernels``,
``models``, ``configs``, ``compiler``, ``serving``, ``launch``) and
imports only ``torch``, numpy and the standard library. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).
"""
