"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "the caller asks for the CPU (device='cpu')")
    return dev


def bind_card_settings(device: torch.device) -> torch.device:
    """On the card, run convolutions and matmuls in full f32 (TF32 off,
    as the reference computes) and make the same seed give the same run:
    cuDNN's fastest weight-gradient algorithms accumulate with atomics in
    an order that changes from run to run, and autotuning may pick
    another algorithm each time (cuBLAS's fixed workspace is set when the
    package is imported, see ``repro_torch/__init__.py``).  Every trainer
    binds these, so its steps run the same convolutions.  Returns
    ``device``."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device
