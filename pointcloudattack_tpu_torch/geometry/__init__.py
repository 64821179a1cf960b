"""Geometry: the closed-form 3x3 eigensolver and normal estimation."""
