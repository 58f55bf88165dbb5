"""TinyLlama-1.1B — llama2-arch small dense LM [arXiv:2401.02385; hf]
(copy of ``repro/configs/tinyllama_1_1b.py``; the reference's
``skip_shapes`` has no field in the port, which runs no shape sweep)."""
from .base import ArchConfig, ConsensusSpec, register


def full() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab=32000,
        param_dtype="bfloat16",
        prune_targets=("ffn", "heads"),
        consensus=ConsensusSpec(granularity="chip"),
    )


def smoke() -> ArchConfig:
    return full().replace(
        param_dtype="float32",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=307,
    )


register("tinyllama-1.1b", full, smoke)
