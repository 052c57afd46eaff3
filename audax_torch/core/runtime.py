"""Device resolution and the float32 precision policy (port of
``audax/core/runtime.py``).

The JAX package pins its platform and compilation cache here; the port's
counterpart decides where tensors live. Entry points take a ``device``
argument: ``None`` means the CUDA card, and a host without one raises --
the port never falls back to the CPU on its own. ``device="cpu"`` runs the
plain PyTorch versions of the kernels (the tests do this).

On CUDA, float32 work stays float32: PyTorch lets cuDNN convolutions run in
TF32 by default, which would break the float32 parity of Whisper's conv
stem with the JAX reference (``audax/models/whisper.py:conv_stem``).
``resolve_device`` therefore turns TF32 off for matmuls and cuDNN whenever
it hands out a CUDA device. These are process-wide PyTorch flags.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "disable_tf32"]

DeviceLike = Optional[Union[str, torch.device]]


def disable_tf32() -> None:
    """Full-float32 matmuls and convolutions on CUDA (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        disable_tf32()
    return dev
