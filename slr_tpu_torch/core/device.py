"""Device selection for the port's entry points.

`device=None` means the CUDA device. The CPU runs only when the caller asks
for it (`device="cpu"`, as the tests do); there is no silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
