"""PyTorch/CUDA port of the CAPSim reproduction (``src/repro`` is the
JAX reference).

File paths mirror the reference package, so each module names the file
it ports.  The package imports ``torch`` and numpy and never ``jax`` or
``repro``: the framework-free host modules it needs (``isa``,
``core.{standardize,context,engine_config,slicer,analytical,sampler,
intervals}``, ``data.dataset``, ``obs``, ``serving.faults``) are its own
copies.  The attention hot path runs on hand-written CUDA
kernels for Hopper (``csrc/``), built with ``nvcc`` at first use.
"""
