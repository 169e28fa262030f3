"""ZNNi on PyTorch and CUDA for an NVIDIA H100: the port of ``repro``.

Mirrors the reference package's layout module for module (``configs``,
``core``, ``kernels``, ``volume``, ``serving``).  It imports neither JAX
nor the reference package.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
