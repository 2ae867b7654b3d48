"""Device selection for the port's entry points: the card by default, the
CPU only when the caller asks for it.  There is no silent fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device (raises without one);
    ``"cpu"`` → the CPU, which runs every kernel's plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dynamo_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
