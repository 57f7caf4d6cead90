"""Device resolution shared by the entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a usable CUDA
    runtime raises ``RuntimeError``: the port never falls back to the
    CPU on its own; callers that want the CPU ask for it.  ``"meta"``
    (shapes and dtypes, no data) is the dry-run's
    (``launch.dryrun``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default is 'cuda') but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {str(dev)!r}: the port "
                           "runs on 'cuda' or 'cpu' (or traces shapes on "
                           "'meta')")
    return dev
