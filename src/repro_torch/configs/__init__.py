"""Config registry: importing this package registers the ResNet family
(the only family the port trains so far)."""
from .base import (ArchConfig, ConsensusSpec, HsadmmConfig, ShapeConfig,
                   get_config, register)

from . import resnet               # noqa: F401

__all__ = ["ArchConfig", "ConsensusSpec", "HsadmmConfig", "ShapeConfig",
           "get_config", "register"]
