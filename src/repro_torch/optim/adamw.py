"""AdamW (decoupled weight decay), f32 moments regardless of param dtype."""
from __future__ import annotations

import torch


def adamw_init(params: dict) -> dict:
    def z(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    device = next(iter(params.values())).device
    return {"m": {k: z(x) for k, x in params.items()},
            "v": {k: z(x) for k, x in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: dict, grads: dict, opt_state: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1) -> tuple[dict, dict]:
    t = opt_state["t"] + 1
    tf = t.to(torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m = b1 * opt_state["m"][k] + (1 - b1) * g32
        v = b2 * opt_state["v"][k] + (1 - b2) * torch.square(g32)
        mh = m / (1 - b1 ** tf)
        vh = v / (1 - b2 ** tf)
        step = mh / (torch.sqrt(vh) + eps) \
            + weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, {"m": new_m, "v": new_v, "t": t}
