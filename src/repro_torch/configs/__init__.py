"""Config registry: importing this package registers the families the
port trains: the ResNet family, Mamba2-780M and TinyLlama-1.1B."""
from .base import (ArchConfig, ConsensusSpec, HsadmmConfig, ShapeConfig,
                   get_config, register)

from . import mamba2_780m          # noqa: F401
from . import resnet               # noqa: F401
from . import tinyllama_1_1b       # noqa: F401

__all__ = ["ArchConfig", "ConsensusSpec", "HsadmmConfig", "ShapeConfig",
           "get_config", "register"]
