"""Weights in the reference state-dict layout."""
