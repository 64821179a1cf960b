"""Perturbation constraints."""
