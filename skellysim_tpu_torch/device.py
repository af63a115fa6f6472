"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None = "cuda") as a `torch.device`.

    Raises when the card is asked for and there is none: a run that was
    meant for the card never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device=cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:<index>"; name the card the same way so
        # device checks compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
