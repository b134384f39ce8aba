"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike) -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError``
    when CUDA is asked for and absent, so that nothing silently runs
    on the CPU without the caller saying so. ``"meta"`` (shapes only,
    nothing allocated) is the dry run's (``launch.dryrun``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {str(dev)!r}")
    return dev
