"""Kernel wrappers and their plain PyTorch versions.

``KERNELS`` lists every CUDA kernel of the port with its plain version, so
a run can reset and read the launch counters of all of them at once.
``int4_matmul_dequant`` (the dequantize + ``torch.matmul`` branch of
``int4_matmul`` for more than 256 rows) is no kernel, but its counter is
reset with theirs.
"""

from audax_torch.ops.attention import (decode_attention_core_cuda,
                                       decode_attention_cuda,
                                       decode_attention_plain,
                                       decode_attention_sm90_cuda,
                                       decode_attention_sm90_int8_cuda,
                                       decode_attention_stacked_cuda,
                                       decode_attention_stacked_int8_cuda,
                                       decode_attention_stacked_int8_plain,
                                       decode_attention_stacked_plain,
                                       flash_backward_dkv_cuda,
                                       flash_backward_dkv_plain,
                                       flash_backward_dkv_tf32x3_cuda,
                                       flash_backward_dkv_wgmma_cuda,
                                       flash_backward_dq_cuda,
                                       flash_backward_dq_plain,
                                       flash_backward_dq_tf32x3_cuda,
                                       flash_backward_dq_wgmma_cuda,
                                       flash_forward_cuda, flash_forward_plain,
                                       flash_forward_tf32x3_cuda,
                                       flash_forward_wgmma_cuda)
from audax_torch.ops.direct_mel import (fused_logmel_fft_cuda,
                                        fused_logmel_fft_plain,
                                        fused_logmel_frames_cuda,
                                        fused_logmel_frames_plain,
                                        fused_logmel_packed_cuda,
                                        fused_logmel_packed_fft_cuda,
                                        fused_logmel_packed_plain)
from audax_torch.ops.fused_mel import (log_mel_overlap_cuda,
                                       log_mel_overlap_fft_cuda,
                                       log_mel_overlap_plain)
from audax_torch.ops.int4_matmul import (int4_matmul_cuda,
                                         int4_matmul_dequant,
                                         int4_matmul_mma_cuda,
                                         int4_matmul_plain)

__all__ = ["KERNELS", "reset_launches", "launch_counts"]

#: kernel name -> (CUDA wrapper, plain PyTorch version); K1's and K4's
#: tiers on the FFT body (``csrc/log_mel_fft.cu``) count apart from their
#: own kernels and from K5's FFT body, each beside its tier's plain version;
#: K9's tensor-core body (``int4_matmul_mma``) apart from its split-half
#: body (``int4_matmul``); K3's and K6's launches (the TPU kernels' counts)
#: also by the body that ran them: ``decode_attention_sm90`` and
#: ``_sm90_int8`` (every call), ``decode_attention_cuda_core`` (the first
#: body, only for an A/B)
KERNELS = {
    "log_mel_overlap": (log_mel_overlap_cuda, log_mel_overlap_plain),
    "log_mel_overlap_fft": (log_mel_overlap_fft_cuda, log_mel_overlap_plain),
    "log_mel_packed": (fused_logmel_packed_cuda, fused_logmel_packed_plain),
    "log_mel_packed_fft": (fused_logmel_packed_fft_cuda,
                           fused_logmel_packed_plain),
    "log_mel_generic": (fused_logmel_frames_cuda, fused_logmel_frames_plain),
    "log_mel_fft": (fused_logmel_fft_cuda, fused_logmel_fft_plain),
    "flash_forward": (flash_forward_cuda, flash_forward_plain),
    "flash_forward_wgmma": (flash_forward_wgmma_cuda, flash_forward_plain),
    "flash_forward_tf32x3": (flash_forward_tf32x3_cuda, flash_forward_plain),
    "flash_backward_dq": (flash_backward_dq_cuda, flash_backward_dq_plain),
    "flash_backward_dkv": (flash_backward_dkv_cuda, flash_backward_dkv_plain),
    "flash_backward_dq_wgmma": (flash_backward_dq_wgmma_cuda,
                                flash_backward_dq_plain),
    "flash_backward_dkv_wgmma": (flash_backward_dkv_wgmma_cuda,
                                 flash_backward_dkv_plain),
    "flash_backward_dq_tf32x3": (flash_backward_dq_tf32x3_cuda,
                                 flash_backward_dq_plain),
    "flash_backward_dkv_tf32x3": (flash_backward_dkv_tf32x3_cuda,
                                  flash_backward_dkv_plain),
    "decode_attention_stacked": (decode_attention_stacked_cuda,
                                 decode_attention_stacked_plain),
    "decode_attention_stacked_int8": (decode_attention_stacked_int8_cuda,
                                      decode_attention_stacked_int8_plain),
    "decode_attention": (decode_attention_cuda, decode_attention_plain),
    "decode_attention_sm90": (decode_attention_sm90_cuda,
                              decode_attention_stacked_plain),
    "decode_attention_sm90_int8": (decode_attention_sm90_int8_cuda,
                                   decode_attention_stacked_int8_plain),
    "decode_attention_cuda_core": (decode_attention_core_cuda,
                                   decode_attention_stacked_plain),
    "int4_matmul": (int4_matmul_cuda, int4_matmul_plain),
    "int4_matmul_mma": (int4_matmul_mma_cuda, int4_matmul_plain),
}


def reset_launches() -> None:
    for cuda_fn, plain_fn in KERNELS.values():
        cuda_fn.launches = 0
        plain_fn.launches = 0
    int4_matmul_dequant.launches = 0


def launch_counts() -> dict:
    """``{name: {"cuda": n, "plain": n}}``."""
    return {name: {"cuda": c.launches, "plain": p.launches}
            for name, (c, p) in KERNELS.items()}
