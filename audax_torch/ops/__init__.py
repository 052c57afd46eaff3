"""Kernel wrappers and their plain PyTorch versions.

``KERNELS`` lists every CUDA kernel of the port with its plain version, so
a run can reset and read the launch counters of all of them at once.
"""

from audax_torch.ops.attention import (decode_attention_stacked_cuda,
                                       decode_attention_stacked_plain,
                                       flash_backward_dkv_cuda,
                                       flash_backward_dkv_plain,
                                       flash_backward_dq_cuda,
                                       flash_backward_dq_plain,
                                       flash_forward_cuda, flash_forward_plain)
from audax_torch.ops.fused_mel import (log_mel_overlap_cuda,
                                       log_mel_overlap_plain)

__all__ = ["KERNELS", "reset_launches", "launch_counts"]

#: kernel name -> (CUDA wrapper, plain PyTorch version)
KERNELS = {
    "log_mel_overlap": (log_mel_overlap_cuda, log_mel_overlap_plain),
    "flash_forward": (flash_forward_cuda, flash_forward_plain),
    "flash_backward_dq": (flash_backward_dq_cuda, flash_backward_dq_plain),
    "flash_backward_dkv": (flash_backward_dkv_cuda, flash_backward_dkv_plain),
    "decode_attention_stacked": (decode_attention_stacked_cuda,
                                 decode_attention_stacked_plain),
}


def reset_launches() -> None:
    for cuda_fn, plain_fn in KERNELS.values():
        cuda_fn.launches = 0
        plain_fn.launches = 0


def launch_counts() -> dict:
    """``{name: {"cuda": n, "plain": n}}``."""
    return {name: {"cuda": c.launches, "plain": p.launches}
            for name, (c, p) in KERNELS.items()}
