"""Direct log-mel on frames: the CUDA kernels K4 (packed) and K5 (generic,
in two bodies) and their plain PyTorch versions.

Port of ``audax/ops/pallas_mel.py``'s ``fused_logmel_packed`` (the tier for
power-2 configs the overlap kernel does not cover) and
``fused_logmel_frames`` (the tier for any spectrogram power != 2):

  * packed:  ``log(((frames @ dft) ** 2) @ fb2)`` with the window-folded
    packed basis and the power-routing filterbank of
    ``ops/mel.py:packed_frontend_constants``;
  * generic: ``re = frames @ cos``, ``im = frames @ sin``,
    ``p = sqrt(max(re^2 + im^2, 0)) ** power``, ``log(p @ fb)`` with the
    constants of ``ops/mel.py:frontend_constants``.

K5 has two bodies, and ``fft_applicable(n_fft, power)`` routes between
them: power != 2 with an n_fft in ``FFT_SIZES`` (the powers of two from 256
to 2048 and Whisper's 400, a mixed-radix instantiation; UrbanSound's 1024
is the main case) takes the FFT body
(``fused_logmel_fft``, ``csrc/log_mel_fft.cu``: ``rfft`` of the windowed
frame, ``|X|^power``, each band summed over its bin range, the log; the
constants of ``ops/mel.py:fft_frontend_constants``), every other n_fft the
direct body (``fused_logmel_frames``, ``csrc/log_mel_direct.cu``). Both
compute the same function; the FFT body is held against the direct body's
plain version on the card.

K4's tier takes the same FFT body at power 2 on the card, for an n_fft in
``FFT_SIZES``: ``fused_logmel_packed_fft_cuda``, counted apart from K5's
launches (``ops/fused_mel.py:BODIES`` routes). On a CPU tensor the tier
keeps its own plain version, ``fused_logmel_packed_plain``.

Any band count. The direct bodies hold at most ``MAX_MELS`` bands in
registers; a wrapper launches them once per chunk of ``band_chunks``, each
chunk writing its own columns of the output (and computing the spectrum
again), every launch counted. The FFT body takes the bands in one launch,
up to what one block's shared memory holds (``fft_smem_bytes``); past that
the wrapper raises before any launch.

``log_mode`` is the kernel's log: "log1e6" is ``log(x + 1e-6)``, "log10"
``log10(max(x, 1e-10))`` (Whisper's clamp stays outside, as in JAX).

``frames`` is ``[..., n_fft]``. The CUDA wrappers take the frame view that
``ops/fused_mel.py:log_mel_fused`` makes of the padded signal
(``unfold``: ``[B, T, n_fft]`` with strides ``(clip, hop, 1)``, or a
contiguous ``[N, n_fft]``) and read it in place, so no ``[N, n_fft]`` copy
is made. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel of ``csrc/log_mel_direct.cu`` (``csrc/log_mel_fft.cu`` for the FFT
body) or raises.
"""

from __future__ import annotations

import torch

from audax_torch.ops import native
from audax_torch.ops.stft import apply_log

__all__ = ["fused_logmel_packed", "fused_logmel_packed_cuda",
           "fused_logmel_packed_plain", "fused_logmel_frames",
           "fused_logmel_frames_cuda", "fused_logmel_frames_plain",
           "FFT_SIZES", "MAX_MELS", "band_chunks", "fft_applicable",
           "fft_smem_bytes",
           "fused_logmel_fft", "fused_logmel_fft_cuda",
           "fused_logmel_fft_plain", "fused_logmel_packed_fft_cuda",
           "launch_fft_body"]

#: mel bands one launch of the direct bodies holds in registers (16 x the
#: widest per-thread row): the width of a chunk of ``band_chunks``
MAX_MELS = 256
#: the kernels' log epilogues, by their flag
_LOG_FLAGS = {"log1e6": 0, "log10": 1}
#: the n_fft the FFT body is built for, in every tier (K1, K4 at power 2;
#: K5 at any other power): the powers of two from 256 to 2048 and Whisper's
#: 400 (L = 200 = 8 x 25 complex points)
FFT_SIZES = (256, 400, 512, 1024, 2048)
#: shared memory one block may use on an H100, and the band count the FFT
#: body's launch takes (``csrc/log_mel_fft.cu``, ``launch<N>``)
_SMEM_LIMIT = 232448
_FFT_MAX_MELS = 8192
#: the FFT body's frames per block and warps per block (``FRAMES``,
#: ``WARPS`` of ``csrc/log_mel_fft.cu``)
_FFT_FRAMES, _FFT_WARPS = 8, 8


def fft_applicable(n_fft: int, power: float) -> bool:
    """The route of the generic tier (power != 2): the FFT body for an n_fft
    in ``FFT_SIZES``, the direct body for any other. Power 2 is K4's (or
    K1's), never this tier's."""
    return power != 2.0 and n_fft in FFT_SIZES


def band_chunks(n_mels: int):
    """The ``(start, stop)`` band ranges the direct bodies launch one at a
    time: consecutive chunks of ``MAX_MELS`` bands, the last one shorter,
    that cover ``range(n_mels)`` once."""
    if n_mels < 1:
        raise ValueError(f"band_chunks: {n_mels} bands")
    return tuple((lo, min(lo + MAX_MELS, n_mels))
                 for lo in range(0, n_mels, MAX_MELS))


def fft_smem_bytes(n_fft: int, n_mels: int) -> int:
    """Dynamic shared memory of one FFT-body block at ``n_fft`` and
    ``n_mels`` bands: ``4 * smem_floats(n_fft, n_mels)`` of
    ``csrc/log_mel_fft.cu`` -- the block's power rows, then either the
    warps' skewed FFT buffers or the mel tile, whichever is larger."""
    half = n_fft // 2
    skewed = half + (half >> 5)
    return 4 * (_FFT_FRAMES * (half + 1)
                + max(_FFT_WARPS * 2 * skewed, _FFT_FRAMES * (n_mels | 1)))


def fused_logmel_packed_plain(frames: torch.Tensor, dft: torch.Tensor,
                              fb2: torch.Tensor,
                              log_mode: str = "log1e6") -> torch.Tensor:
    """Plain version of K4: ``[..., n_fft]`` frames -> ``[..., M]``."""
    fused_logmel_packed_plain.launches += 1
    ri = frames @ dft
    return apply_log((ri * ri) @ fb2, log_mode)


fused_logmel_packed_plain.launches = 0


def fused_logmel_frames_plain(frames: torch.Tensor, cos_w: torch.Tensor,
                              sin_w: torch.Tensor, fb: torch.Tensor,
                              log_mode: str = "log1e6",
                              power: float = 2.0) -> torch.Tensor:
    """Plain version of K5: ``[..., n_fft]`` frames -> ``[..., M]``."""
    fused_logmel_frames_plain.launches += 1
    real = frames @ cos_w
    imag = frames @ sin_w
    p = real * real + imag * imag
    if power != 2.0:
        p = torch.pow(torch.sqrt(torch.clamp_min(p, 0.0)), power)
    return apply_log(p @ fb, log_mode)


fused_logmel_frames_plain.launches = 0


def _frame_view(frames: torch.Tensor):
    """``frames`` as ``[B, T, n_fft]`` with unit sample stride, plus the
    clip stride and the hop (the stride between frames)."""
    if not frames.is_cuda or frames.dtype != torch.float32:
        raise ValueError("the direct log-mel kernels take a float32 CUDA "
                         f"tensor, got {frames.dtype} on {frames.device}")
    if frames.ndim == 2:
        frames = frames.unsqueeze(0)
    if frames.ndim != 3 or frames.stride(-1) != 1:
        raise ValueError("frames must be [N, n_fft] or [B, T, n_fft] with "
                         f"unit sample stride, got {tuple(frames.shape)} "
                         f"strides {frames.stride()}")
    return frames, frames.stride(0), frames.stride(1)


def _check_constant(t: torch.Tensor, shape, name: str) -> None:
    if (tuple(t.shape) != tuple(shape) or not t.is_cuda
            or t.dtype != torch.float32 or not t.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous float32 CUDA tensor of "
                         f"shape {tuple(shape)}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _launch(generic: int, frames, basis0, basis1, width, fb, log_mode,
            power):
    """The direct body once per chunk of ``band_chunks``, each chunk's
    filterbank and output columns addressed in place (row stride M):
    ``(out [..., M], launches)``."""
    lead = frames.shape[:-1]
    f3, clip_stride, hop = _frame_view(frames)
    b, t, n_fft = f3.shape
    m = fb.shape[1]
    if m < 1:
        raise ValueError("the direct log-mel kernels need at least one band")
    out = torch.empty(b * t, m, device=f3.device)
    if b * t == 0:
        return out.reshape(lead + (m,)), 0
    lib = native.library("log_mel_direct")
    chunks = band_chunks(m)
    for lo, hi in chunks:
        status = lib.log_mel_direct_f32(
            generic, f3.data_ptr(), clip_stride, hop, t, b * t, n_fft,
            basis0.data_ptr(), basis1.data_ptr(), width,
            fb.data_ptr() + 4 * lo, out.data_ptr() + 4 * lo, hi - lo, m,
            _LOG_FLAGS[log_mode], float(power),
            torch.cuda.current_stream(f3.device).cuda_stream)
        native.check(status, "log_mel_direct")
    return out.reshape(lead + (m,)), len(chunks)


def fused_logmel_packed_cuda(frames: torch.Tensor, dft: torch.Tensor,
                             fb2: torch.Tensor,
                             log_mode: str = "log1e6") -> torch.Tensor:
    """K4: same contract as ``fused_logmel_packed_plain``."""
    n_fft, width = frames.shape[-1], dft.shape[1]
    _check_constant(dft, (n_fft, width), "dft")
    _check_constant(fb2, (width, fb2.shape[1]), "fb2")
    out, launches = _launch(0, frames, dft, dft, width, fb2, log_mode, 2.0)
    fused_logmel_packed_cuda.launches += launches
    return out


fused_logmel_packed_cuda.launches = 0


def fused_logmel_frames_cuda(frames: torch.Tensor, cos_w: torch.Tensor,
                             sin_w: torch.Tensor, fb: torch.Tensor,
                             log_mode: str = "log1e6",
                             power: float = 2.0) -> torch.Tensor:
    """K5: same contract as ``fused_logmel_frames_plain``."""
    n_fft, f = frames.shape[-1], cos_w.shape[1]
    _check_constant(cos_w, (n_fft, f), "cos_w")
    _check_constant(sin_w, (n_fft, f), "sin_w")
    _check_constant(fb, (f, fb.shape[1]), "fb")
    out, launches = _launch(1, frames, cos_w, sin_w, f, fb, log_mode, power)
    fused_logmel_frames_cuda.launches += launches
    return out


fused_logmel_frames_cuda.launches = 0


def fused_logmel_packed(frames, dft, fb2, log_mode="log1e6"):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    if frames.is_cuda:
        return fused_logmel_packed_cuda(frames, dft, fb2, log_mode)
    return fused_logmel_packed_plain(frames, dft, fb2, log_mode)


def fused_logmel_frames(frames, cos_w, sin_w, fb, log_mode="log1e6",
                        power=2.0):
    """K5 for a CUDA tensor, its plain version for a CPU tensor."""
    if frames.is_cuda:
        return fused_logmel_frames_cuda(frames, cos_w, sin_w, fb, log_mode,
                                        power)
    return fused_logmel_frames_plain(frames, cos_w, sin_w, fb, log_mode,
                                     power)


def _band_weights(fb: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """``fb`` with every weight outside its band's bin range zeroed."""
    k = torch.arange(fb.shape[0], device=fb.device)[:, None]
    lo, hi = ranges[:, 0].to(fb.device), ranges[:, 1].to(fb.device)
    return torch.where((k >= lo) & (k < hi), fb, torch.zeros_like(fb))


def fused_logmel_fft_plain(frames: torch.Tensor, window: torch.Tensor,
                           fb: torch.Tensor, ranges: torch.Tensor,
                           twiddles: torch.Tensor, log_mode: str = "log1e6",
                           power: float = 2.0) -> torch.Tensor:
    """Plain version of K5's FFT body: ``[..., n_fft]`` frames ->
    ``[..., M]`` as ``rfft(frames * window)``, ``|X|^power``, each band
    summed over its bin range of ``ranges``, the log (``torch.fft``
    computes its own twiddles)."""
    fused_logmel_fft_plain.launches += 1
    if frames.numel() == 0:             # no frame: MKL's rfft refuses it
        return frames.new_zeros(frames.shape[:-1] + fb.shape[-1:])
    spec = torch.fft.rfft(frames * window)
    p = spec.real * spec.real + spec.imag * spec.imag
    if power != 2.0:
        p = torch.pow(torch.sqrt(torch.clamp_min(p, 0.0)), power)
    return apply_log(p @ _band_weights(fb, ranges), log_mode)


fused_logmel_fft_plain.launches = 0


def launch_fft_body(frames, window, fb, ranges, twiddles, log_mode, power,
                    sizes):
    """One launch of ``csrc/log_mel_fft.cu`` on the frame view, read in
    place, for an n_fft in ``sizes``: ``(out [..., M], launched)``. Any
    band count the kernel takes: 1 to 8192 bands whose tile fits one
    block's shared memory (``fft_smem_bytes``); others raise here, before
    any launch."""
    n_fft = frames.shape[-1]
    if n_fft not in sizes:
        raise ValueError(f"the FFT log-mel body takes n_fft in {sizes}, "
                         f"got {n_fft}")
    f, m = n_fft // 2 + 1, fb.shape[-1]
    if not 1 <= m <= _FFT_MAX_MELS:
        raise ValueError(f"the FFT log-mel body takes 1..{_FFT_MAX_MELS} "
                         f"mel bands, got {m}")
    smem = fft_smem_bytes(n_fft, m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the FFT log-mel body at n_fft {n_fft} with {m} "
                         f"bands needs {smem} B of shared memory; one block "
                         f"may use {_SMEM_LIMIT} B")
    _check_constant(window, (n_fft,), "window")
    _check_constant(fb, (f, m), "fb")
    _check_constant(twiddles, (n_fft + 1, 2), "twiddles")
    if (tuple(ranges.shape) != (m, 2) or ranges.dtype != torch.int32
            or not ranges.is_cuda or not ranges.is_contiguous()):
        raise ValueError(f"ranges: want a contiguous int32 CUDA tensor of "
                         f"shape ({m}, 2), got {tuple(ranges.shape)} "
                         f"{ranges.dtype} on {ranges.device}")
    lead = frames.shape[:-1]
    f3, clip_stride, hop = _frame_view(frames)
    b, t, _ = f3.shape
    out = torch.empty(b * t, m, device=f3.device)
    if b * t == 0:
        return out.reshape(lead + (m,)), False
    status = native.library("log_mel_fft").log_mel_fft_f32(
        f3.data_ptr(), clip_stride, hop, t, b * t, n_fft, window.data_ptr(),
        twiddles.data_ptr(), fb.data_ptr(), ranges.data_ptr(),
        out.data_ptr(), m, _LOG_FLAGS[log_mode], float(power),
        torch.cuda.current_stream(f3.device).cuda_stream)
    native.check(status, "log_mel_fft")
    return out.reshape(lead + (m,)), True


def fused_logmel_fft_cuda(frames: torch.Tensor, window: torch.Tensor,
                          fb: torch.Tensor, ranges: torch.Tensor,
                          twiddles: torch.Tensor, log_mode: str = "log1e6",
                          power: float = 2.0) -> torch.Tensor:
    """K5's FFT body (``csrc/log_mel_fft.cu``): same contract as
    ``fused_logmel_fft_plain``, on the frame view read in place, for an
    n_fft in ``FFT_SIZES``. ``ranges`` must hold every non-zero of ``fb``
    (``ops/mel.py:mel_bin_ranges``)."""
    out, launched = launch_fft_body(frames, window, fb, ranges, twiddles,
                                    log_mode, power, FFT_SIZES)
    fused_logmel_fft_cuda.launches += launched
    return out


fused_logmel_fft_cuda.launches = 0


def fused_logmel_packed_fft_cuda(frames: torch.Tensor, window: torch.Tensor,
                                 fb: torch.Tensor, ranges: torch.Tensor,
                                 twiddles: torch.Tensor,
                                 log_mode: str = "log1e6") -> torch.Tensor:
    """K4's tier on the FFT body (``csrc/log_mel_fft.cu`` at power 2) for an
    n_fft in ``FFT_SIZES``: the function of
    ``fused_logmel_packed_plain`` from the constants of
    ``ops/mel.py:fft_frontend_constants``, on the frame view read in
    place."""
    out, launched = launch_fft_body(frames, window, fb, ranges, twiddles,
                                    log_mode, 2.0, FFT_SIZES)
    fused_logmel_packed_fft_cuda.launches += launched
    return out


fused_logmel_packed_fft_cuda.launches = 0


def fused_logmel_fft(frames, window, fb, ranges, twiddles, log_mode="log1e6",
                     power=2.0):
    """K5's FFT body for a CUDA tensor, its plain version for a CPU
    tensor."""
    if frames.is_cuda:
        return fused_logmel_fft_cuda(frames, window, fb, ranges, twiddles,
                                     log_mode, power)
    return fused_logmel_fft_plain(frames, window, fb, ranges, twiddles,
                                  log_mode, power)
