from .mvsnet import MVSEncoder
from .nerf import NeRFField

__all__ = ["MVSEncoder", "NeRFField"]
