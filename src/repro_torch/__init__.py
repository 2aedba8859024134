"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; each module here keeps the
name and place of its counterpart there (``repro_torch/models/lm.py`` ↔
``repro/models/lm.py``) and is held against it by the tests.  The port
imports ``torch``, numpy and the standard library, never ``jax`` and nothing
of ``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
