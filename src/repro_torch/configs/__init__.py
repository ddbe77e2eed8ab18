"""Config registry of the port: the ten language-model architectures."""
from .lm_archs import ARCHS, get_arch, reduced

__all__ = ["ARCHS", "get_arch", "reduced"]
