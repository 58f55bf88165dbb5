"""Model zoo of the port: one builder per architecture family.  Only the
ResNet family (``family="cnn"``) is ported so far."""
from ..configs.base import ArchConfig
from .api import ModelBundle


def _cnn_only(cfg: ArchConfig, what: str):
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"{what} of model family {cfg.family!r} is not ported yet; the "
            "PyTorch port covers the ResNet family (family='cnn') so far")
    from . import cnn
    return cnn


def build(cfg: ArchConfig) -> ModelBundle:
    return _cnn_only(cfg, "build").build(cfg)


def shrink_config(cfg: ArchConfig, plan, budgets: dict) -> ArchConfig:
    """ArchConfig of the physically-shrunk model (every compactable rule's
    group dimension replaced by its static budget B) — the width mapping
    behind ``Engine.reconfigure``.  The ResNet family reads its per-stage
    stream / internal / stem widths off the coupling classes; every other
    family raises."""
    return _cnn_only(cfg, "shrink_config").shrink_config(cfg, plan, budgets)


__all__ = ["build", "ModelBundle", "shrink_config"]
