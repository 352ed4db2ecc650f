"""PyTorch/CUDA port of the Token Coherence simulator.

A second package beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``, and keeps
the reference's module and function names.  Public entry points take
``device=None``, which means ``"cuda"``; pass ``device="cpu"`` to run
the plain PyTorch route without a card.
"""
