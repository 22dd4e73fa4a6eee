"""Device selection for the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU: `resolve_device(None)` is `cuda`, and a request for `cuda`
on a host without a usable card raises instead of falling back.  The CPU
is only ever chosen explicitly (`device="cpu"`), which is what the tests
and the reference comparison in `chip_smoke.py` do.
"""

from __future__ import annotations

from typing import Optional, Union

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
