"""Optimizers and the Top-K compression baseline (port of ``repro/optim``),
over the port's flat ``{leaf key: tensor}`` parameter dicts."""
from .sgd import sgd_init, sgd_update
from .adamw import adamw_init, adamw_update
from .schedule import cosine_schedule, constant_schedule
from .topk_compression import topk_compress_state, topk_grad_exchange

__all__ = ["sgd_init", "sgd_update", "adamw_init", "adamw_update",
           "cosine_schedule", "constant_schedule", "topk_compress_state",
           "topk_grad_exchange"]
