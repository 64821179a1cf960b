"""Adversarial and distance losses."""
