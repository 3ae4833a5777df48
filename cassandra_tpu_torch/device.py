"""Device resolution for the port's entry points.

Entry points take `device=` and default to `cuda`. Without a card the
default raises: the port never carries on on the CPU unless the caller
asks for it with `device="cpu"` (which runs the plain PyTorch versions
of the kernels, as the CPU tests do)."""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on: `device` if given, else
    `cuda`. Raises when a CUDA device is asked for and none is present,
    and for device types that have neither a kernel nor a plain
    version here."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port's kernels need an "
                "NVIDIA card; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
