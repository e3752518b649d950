"""Histogram kernel: degree histograms and id bincounts."""
