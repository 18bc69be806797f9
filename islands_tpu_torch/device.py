"""Device resolution for the port's entry points.

The port runs on an NVIDIA GPU. `device=None` means `cuda`; without a card
that raises instead of falling back, so a run never lands on the CPU by
accident. Callers (tests) ask for the CPU with `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "islands_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`a` (a tensor, numpy array or nested sequence) as a tensor on
    `device`. Non-tensor input is copied, so read-only numpy arrays (such as
    np.asarray of a jax array) are safe to pass."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device, dtype) if dtype is not None else a.to(device)
