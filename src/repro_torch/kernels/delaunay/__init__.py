"""Batched Delaunay triangulation (Bowyer-Watson) and the shared Cramer
circumsphere predicate."""
