"""Deterministic synthetic image streams — port of
``repro/data/synthetic.py`` for the CNN family.

The numpy generators are the reference's, byte for byte, so both packages
train on the same batches; each batch becomes torch tensors on the
stream's ``device``.  The token streams of the LM families wait for the
slices that port those families.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class SyntheticImages:
    """CIFAR-like labelled images with class-dependent structure."""
    img_size: int
    n_classes: int
    batch: int           # per worker
    workers: int
    noise: float = 0.7
    device: str = "cuda"

    def batch_at(self, step: int) -> dict:
        """The batch of ``step`` (f32 NHWC images and i32 labels with a
        leading worker dim) on the stream's device."""
        rng = np.random.default_rng((step << 16) + 23)
        labels = rng.integers(0, self.n_classes,
                              size=(self.workers, self.batch))
        base = np.linspace(-1, 1, self.n_classes)[labels]  # class mean
        grid = np.linspace(0, np.pi * 2, self.img_size)
        pattern = np.sin(grid)[None, None, :, None, None] \
            * np.cos(grid * 2)[None, None, None, :, None]
        imgs = base[..., None, None, None] * (1 + pattern) \
            + self.noise * rng.standard_normal(
                (self.workers, self.batch, self.img_size, self.img_size, 3))
        return {"images": torch.from_numpy(imgs.astype(np.float32))
                .to(self.device),
                "labels": torch.from_numpy(labels.astype(np.int32))
                .to(self.device)}


def make_stream(cfg, shape, workers: int, device=None):
    """The synthetic stream of ``cfg``; its batches land on ``device`` (the
    card unless the caller asks for the CPU)."""
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"no synthetic stream for family {cfg.family!r} in the port yet")
    return SyntheticImages(cfg.img_size, cfg.n_classes,
                           max(shape.global_batch // workers, 1), workers,
                           device=str(resolve_device(device)))
