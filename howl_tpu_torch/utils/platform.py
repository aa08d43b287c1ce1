"""Device selection (counterpart of ``howl_tpu/utils/platform.py``).

The JAX package's ``ensure_platform`` makes ``JAX_PLATFORMS`` (or
``SETTINGS.training.device``) win over a platform pinned by a deployment's
``sitecustomize``. PyTorch has no such pin: a device is named per call. Here
``ensure_platform`` resolves the device a run asks for, its argument or
``SETTINGS.training.device``, to a ``torch.device``; every entry point of
the port resolves its ``--device`` through :func:`resolve_device`. A CUDA
device that does not exist raises: nothing falls back to the CPU by itself.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name) -> torch.device:
    """The device a run asks for: a CUDA device that exists, or the CPU.
    Nothing falls back to the CPU by itself."""
    if str(name).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port runs on 'cuda' or 'cpu'")
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available (pass --device cpu to run on the CPU)")
    return device


def ensure_platform(device: Optional[str] = None) -> torch.device:
    """``device``, or ``SETTINGS.training.device`` when it is None, as a
    ``torch.device`` (:func:`resolve_device`)."""
    if device is None:
        from howl_tpu_torch.settings import SETTINGS

        device = SETTINGS.training.device
    return resolve_device(device)
