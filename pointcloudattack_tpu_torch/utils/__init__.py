"""Model apply helpers."""
