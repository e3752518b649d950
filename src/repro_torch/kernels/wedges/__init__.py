"""Wedge-closing kernel of the sampled clustering pass (``close_wedges``)."""
