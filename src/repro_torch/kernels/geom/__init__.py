"""Geometric engine kernels: candidate-pair edges (RGG/RHG) and cell points."""
