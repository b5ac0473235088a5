from .config import TrainConfig, load_hyp

__all__ = ["TrainConfig", "load_hyp"]
