from temporalalignnet_torch.core.config import (
    DataConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    Precision,
    TrainConfig,
)

__all__ = ["DataConfig", "EvalConfig", "LossConfig", "ModelConfig", "Precision", "TrainConfig"]
