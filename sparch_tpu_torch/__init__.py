"""PyTorch/CUDA port of sparch_tpu.

The JAX package ``sparch_tpu`` is the reference: each module here keeps the
name of its counterpart there, and the tests hold the two against each other
on the CPU. The recurrences that the JAX package runs as Pallas kernels on a
TPU run here as hand-written CUDA kernels (``csrc/``), built with ``nvcc``
at first use (``_build.py``); on CPU tensors the same functions run their
plain PyTorch versions.

This package imports ``torch`` and never ``jax``, ``flax`` or
``sparch_tpu``.
"""
