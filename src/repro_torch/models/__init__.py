"""Model zoo: the dense decoder family with the tokens frontend."""
from .lm import LM

__all__ = ["LM"]
