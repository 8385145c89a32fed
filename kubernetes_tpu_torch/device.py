"""Device resolution for the port's entry points.

Every entry point takes ``device``. ``None`` means the card: it resolves to
``torch.device("cuda")`` and raises when CUDA is absent. Nothing falls back
to the CPU quietly; the CPU runs only when the caller asks for it, as the
tests do with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but CUDA is not available")
    return dev
