from surel_plus_tpu_torch.train.loop import (
    LinkPredictor,
    TrainConfig,
    evaluate,
    train_epoch,
)

__all__ = ["LinkPredictor", "TrainConfig", "evaluate", "train_epoch"]
