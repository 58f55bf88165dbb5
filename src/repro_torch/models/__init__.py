"""Model zoo of the port: one builder per architecture family.  Only the
ResNet family (``family="cnn"``) is ported so far."""
from ..configs.base import ArchConfig
from .api import ModelBundle


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the PyTorch "
            "port builds the ResNet family (family='cnn') so far")
    from . import cnn
    return cnn.build(cfg)


__all__ = ["build", "ModelBundle"]
