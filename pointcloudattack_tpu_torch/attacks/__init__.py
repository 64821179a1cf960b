"""Attacks: the shared C&W engine and the CW perturbation front end."""
