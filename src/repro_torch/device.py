"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Callable

import torch

_CONSTS: dict = {}


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """Resolve ``device`` and fix the float32 matmul contract.

    The default is the card.  Asking for CUDA where there is none raises:
    only an explicit ``"cpu"`` runs on the host.  TF32 is switched off for
    matmuls and convolutions, because a 10-bit mantissa flips KPM
    thresholds and breaks the float32 contract of the experts.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the host"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def cached_const(key: tuple, device: torch.device | str, build: Callable):
    """A constant of the slot loop, built once on the host and kept on
    ``device``: an upload from pageable host memory on every call would
    make the host wait for the card's queue to drain each time.  ``build()``
    returns one array-like or a tuple of them; ``key`` names the constant."""
    dev = torch.device(device)
    out = _CONSTS.get(key + (dev,))
    if out is None:
        built = build()
        out = (tuple(torch.as_tensor(b).to(dev) for b in built)
               if isinstance(built, tuple) else torch.as_tensor(built).to(dev))
        _CONSTS[key + (dev,)] = out
    return out
