from surel_plus_tpu_torch.train.loop import TrainConfig

__all__ = ["TrainConfig"]
