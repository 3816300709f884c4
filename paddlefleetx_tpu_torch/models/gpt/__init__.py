"""GPT: config, model, weight bridge, generation and the serving module."""

from .config import GPTConfig
from .model import GPTForPretraining, build_model

__all__ = ["GPTConfig", "GPTForPretraining", "build_model"]
