from temporalalignnet_torch.core.config import EvalConfig, ModelConfig, Precision

__all__ = ["EvalConfig", "ModelConfig", "Precision"]
