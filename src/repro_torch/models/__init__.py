"""Model zoo of the port: one builder per architecture family.  The ResNet
family (``family="cnn"``), the Mamba2 SSM (``family="ssm"``) and the
dense GQA transformer (``family="dense"``) are ported so far."""
from ..configs.base import ArchConfig
from .api import ModelBundle


def _family_module(fam: str):
    """The ONE family dispatch ``build`` and ``shrink_config`` use (imports
    kept off the startup path)."""
    if fam == "cnn":
        from . import cnn as m
    elif fam == "ssm":
        from . import ssm as m
    elif fam == "dense":
        from . import transformer as m
    else:
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet; the PyTorch port "
            "covers the ResNet family (family='cnn'), the Mamba2 SSM "
            "(family='ssm') and the dense transformer (family='dense') so "
            "far")
    return m


def build(cfg: ArchConfig) -> ModelBundle:
    return _family_module(cfg.family).build(cfg)


def can_shrink(cfg: ArchConfig) -> bool:
    """Does the family map budgets onto widths (``shrink_config``)?"""
    return hasattr(_family_module(cfg.family), "shrink_config")


def shrink_config(cfg: ArchConfig, plan, budgets: dict) -> ArchConfig:
    """ArchConfig of the physically-shrunk model (every compactable rule's
    group dimension replaced by its static budget B) — the width mapping
    behind ``Engine.reconfigure``.  The ResNet family reads its per-stage
    stream / internal / stem widths off the coupling classes, the dense
    transformer sets ``d_ff`` and its GQA group counts; a family without
    a mapping (the SSM, as in the reference) raises."""
    if not can_shrink(cfg):
        raise NotImplementedError(
            f"physical reconfiguration has no width mapping for model "
            f"family {cfg.family!r}")
    return _family_module(cfg.family).shrink_config(cfg, plan, budgets)


__all__ = ["build", "ModelBundle", "can_shrink", "shrink_config"]
