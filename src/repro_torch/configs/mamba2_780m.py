"""Mamba2-780M — SSD (state-space duality), attention-free
[arXiv:2405.21060] (copy of ``repro/configs/mamba2_780m.py``)."""
from .base import ArchConfig, ConsensusSpec, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_chunk=256,
        param_dtype="bfloat16",
        prune_targets=("ssm_heads",),
        consensus=ConsensusSpec(granularity="chip"),
    )


def smoke() -> ArchConfig:
    return full().replace(
        param_dtype="float32",
        n_layers=2,
        d_model=64,
        vocab=211,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
    )


register("mamba2-780m", full, smoke)
