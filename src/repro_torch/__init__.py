"""repro_torch: the PyTorch/CUDA port of ``repro`` (communication-free
graph generation, arXiv:1710.07565) for one NVIDIA H100.

The package mirrors ``src/repro/``: each module sits at the path of the
reference module it is checked against.  Its hot path runs through CUDA
kernels written for ``sm_90a`` (``kernels/*/csrc``), built with ``nvcc``
at first use; every kernel has a plain PyTorch version that the CPU
runs.  It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.  Entry points: :mod:`repro_torch.api`.
"""
__version__ = "0.1.0"
