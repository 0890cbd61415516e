"""Device resolution: CUDA by default, the CPU only when asked for."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Turn an entry point's ``device`` argument into a ``torch.device``.

    ``None`` means CUDA. A CUDA device with no card present raises a
    ``RuntimeError``: the port never falls back to the CPU quietly. Pass
    ``device="cpu"`` to run there on purpose (the CPU tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU explicitly")
    return dev

