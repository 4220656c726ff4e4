from surel_plus_tpu_torch.spg.spg import SpG, SpGDevice, SpGKeys

__all__ = ["SpG", "SpGDevice", "SpGKeys"]
