from surel_plus_tpu_torch.models.honet import HONet
from surel_plus_tpu_torch.models.net import Net

__all__ = ["Net", "HONet"]
