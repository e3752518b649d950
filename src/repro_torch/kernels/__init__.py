"""Hand-written CUDA kernels of the port: each package holds its
``csrc/`` sources, an ``ops.py`` wrapper and a plain ``ref.py``."""
