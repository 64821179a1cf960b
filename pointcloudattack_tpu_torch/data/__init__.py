"""Datasets."""

from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds

__all__ = ["make_synthetic_clouds"]
