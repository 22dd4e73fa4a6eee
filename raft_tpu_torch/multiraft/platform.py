"""Device selection for the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU: `resolve_device(None)` is `cuda`, and a request for `cuda`
on a host without a usable card raises instead of falling back.  The CPU
is only ever chosen explicitly (`device="cpu"`), which is what the tests
and the reference comparison in `chip_smoke.py` do.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point should allocate on.

    None means `cuda`.  A CUDA device is returned only when
    `torch.cuda.is_available()`; otherwise this raises RuntimeError, so a
    host without a card never silently runs the plain CPU versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raft_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU"
        )
    return dev


def check_operands(
    kernel: str,
    device: torch.device,
    groups: Iterable[Tuple[Dict[str, torch.Tensor], Tuple[int, ...], torch.dtype]],
) -> None:
    """Raise ValueError unless every tensor of every (tensors by name,
    shape, dtype) group lies on `device` with that shape and dtype and is
    contiguous: what a kernel launched on raw pointers relies on."""
    for tensors, shape, dtype in groups:
        for name, t in tensors.items():
            if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"{kernel}: {name} must be {dtype} {list(shape)} on "
                    f"{device}, got {t.dtype} {list(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: {name} must be contiguous")
