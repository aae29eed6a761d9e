"""Model zoo: the dense, xLSTM, Mamba + MoE, audio and vision families."""
from .lm import LM

__all__ = ["LM"]
