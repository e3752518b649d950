"""Pair-mask kernel: the RGG Euclidean and RHG hyperbolic threshold tests."""
