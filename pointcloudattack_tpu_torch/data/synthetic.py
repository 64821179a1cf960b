"""Synthetic point-cloud datasets for tests and the smoke run.

Counterpart of ``pointcloudattack_tpu/data/synthetic.py``, in numpy with
the same draws, so a seed gives the same clouds in both packages.  Class
c is a unit-normalized noisy shape with class-dependent anisotropy.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_clouds(
    num_classes: int,
    per_class: int,
    num_points: int,
    seed: int = 0,
):
    """Returns (clouds [M, N, 3] float32, labels [M] int32), shuffled."""
    rng = np.random.RandomState(seed)
    clouds, labels = [], []
    for c in range(num_classes):
        # class-specific axis scaling + fixed rotation
        scale = np.float32([1.0 + 0.8 * c, 1.0 / (1.0 + 0.5 * c), 1.0])
        theta = np.pi * c / max(num_classes, 1)
        cos, sin = np.cos(theta), np.sin(theta)
        rot = np.float32([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]])
        for _ in range(per_class):
            pts = rng.randn(num_points, 3).astype(np.float32) * scale
            pts = pts @ rot.T
            pts -= pts.mean(axis=0, keepdims=True)
            pts /= np.abs(pts).max() + 1e-9
            clouds.append(pts)
            labels.append(c)
    clouds = np.stack(clouds)
    labels = np.asarray(labels, dtype=np.int32)
    perm = rng.permutation(len(labels))
    return clouds[perm], labels[perm]
