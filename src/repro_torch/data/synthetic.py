"""Deterministic synthetic data streams — port of
``repro/data/synthetic.py``: labelled images for the CNN family, Zipf-ish
token streams with a planted bigram for the LM families.

The numpy generators are the reference's, draw for draw, so both packages
train on the same batches; each batch becomes torch tensors on the
stream's ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class SyntheticLM:
    """Power-law unigram tokens; an even token is followed by its
    successor (mod V) with probability 1/2."""
    vocab: int
    seq_len: int
    batch: int           # per worker
    workers: int
    alpha: float = 1.2   # zipf exponent
    device: str = "cuda"

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``: i32 tokens (workers, batch, seq_len) on
        the stream's device."""
        rng = np.random.default_rng((step << 16) + 17)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.alpha)
        p /= p.sum()
        toks = rng.choice(self.vocab, size=(self.workers, self.batch,
                                            self.seq_len), p=p)
        plant = rng.random((self.workers, self.batch, self.seq_len)) < 0.5
        prev = np.roll(toks, 1, axis=-1)
        toks = np.where(plant & (prev % 2 == 0), (prev + 1) % self.vocab,
                        toks)
        return {"tokens": torch.from_numpy(toks.astype(np.int32))
                .to(self.device)}


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


# LM families the port has models for; the others get their token stream
# with their model
_LM_FAMILIES = ("ssm", "dense")


def make_stream(cfg, shape, workers: int, device=None):
    """The synthetic stream of ``cfg``; its batches land on ``device`` (the
    card unless the caller asks for the CPU)."""
    per_worker = max(shape.global_batch // workers, 1)
    if cfg.family == "cnn":
        return SyntheticImages(cfg.img_size, cfg.n_classes, per_worker,
                               workers, device=str(resolve_device(device)))
    if cfg.family in _LM_FAMILIES:
        return SyntheticLM(cfg.vocab, shape.seq_len, per_worker, workers,
                           device=str(resolve_device(device)))
    raise NotImplementedError(
        f"no synthetic stream for family {cfg.family!r} in the port yet")
