"""Chunk sampler kernels: per-slot Threefry draws and index decodes."""
