"""The pre-processing defenses: SOR, SRS and DUP-Net (SOR, then PU-Net)."""

from pointcloudattack_tpu_torch.defense.dupnet import DUPNet
from pointcloudattack_tpu_torch.defense.sor import sor_defense
from pointcloudattack_tpu_torch.defense.srs import srs_defense

__all__ = ["sor_defense", "srs_defense", "DUPNet"]
