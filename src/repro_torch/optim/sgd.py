"""SGD with momentum + weight decay (paper §5.1.5 baseline optimizer)."""
from __future__ import annotations

import torch


def sgd_init(params: dict) -> dict:
    return {"mom": {k: torch.zeros_like(x) for k, x in params.items()}}


def sgd_update(params: dict, grads: dict, opt_state: dict, *, lr,
               momentum=0.9, weight_decay=0.0) -> tuple[dict, dict]:
    new_p, new_m = {}, {}
    for k, p in params.items():
        g = grads[k] + weight_decay * p if weight_decay else grads[k]
        m = momentum * opt_state["mom"][k] + g
        new_p[k] = (p - torch.as_tensor(lr, device=p.device).to(p.dtype)
                    * m).to(p.dtype)
        new_m[k] = m
    return new_p, {"mom": new_m}
