from surel_plus_tpu_torch.spg.spg import SpGKeys

__all__ = ["SpGKeys"]
