"""repro_torch — the PyTorch/CUDA port of the ``repro`` stack.

The JAX package ``repro`` is the reference; this package repeats its serving
main path on an NVIDIA GPU: TRQ quantizer, PIM backend registry, weight-
stationary plan, dense GQA decoder, compiled ``Runtime`` and paged
``ServeEngine``.  Every projection on the ``pallas`` datapath runs the
hand-written CUDA kernel ``trq_group_mvm`` (``kernels/csrc``).  Module names
follow the JAX package so each counterpart is easy to find.  Nothing here
imports ``jax`` or ``repro``.
"""
