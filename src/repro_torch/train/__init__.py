"""Serving of the LM (training comes next)."""
