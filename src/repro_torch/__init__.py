"""PyTorch + CUDA port of the ``repro`` package, slice by slice.

The JAX package under ``src/repro`` is the reference; this package imports
``torch`` and never ``jax`` or ``repro``. Entry points run on ``cuda``
unless the caller asks for ``cpu`` (see :mod:`repro_torch.device`).
"""
