"""PyTorch/CUDA port of the Opara reproduction (the JAX package ``repro`` is
the reference it is held against).

This package imports ``torch`` and ``numpy`` and never ``jax`` or
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of running on the CPU.
"""
