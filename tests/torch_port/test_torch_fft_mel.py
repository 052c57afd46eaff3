"""K5's FFT body (``csrc/log_mel_fft.cu``) on the CPU: its constants, its
routing, and its formulation against the JAX package.

* ``ops/mel.py:fft_frontend_constants``: the window is exactly the one
  ``frontend_constants`` folds into its DFT bases (``cos_w[:, 0]``), and
  every band's bin range covers every non-zero of its filterbank column.
* The FFT formulation -- ``rfft`` of the windowed frame, ``|X|^power``,
  each band summed over its range, the log -- written out in numpy here,
  and the port's plain version of the body, against JAX's
  ``fused_logmel_frames`` (its Pallas kernel in interpret mode) within
  2e-4 in the log domain, the bound ``test_torch_logmel_direct.py`` holds
  the direct tiers to: both are float32 sums in different orders.
* The kernel's own radix-2 schedule, transcribed into numpy with the
  twiddle table the kernel reads (``fft_twiddles``), equals numpy's float64
  ``rfft`` to float32 rounding at each power-of-two size: the table's
  layout and the four-step index map are right (the 400-point mixed radix
  is ``test_torch_fft_mel400.py``'s).
* ``direct_mel.fft_applicable`` sends each (n_fft, power) to its tier --
  Whisper's n_fft 400 to the FFT body too -- and the dispatcher follows it
  on a CPU tensor; at n_fft 400 the port's frontend (the FFT body's plain
  version) matches JAX's generic tier within 2e-3 at power 1 and 1.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import MelConfig as JaxMelConfig
from audax.ops.pallas_mel import fused_logmel_frames
from audax.ops.stft import frame_signal
from audax_torch.core.config import MelConfig
from audax_torch.frontend import LogMelFrontend
from audax_torch.ops import direct_mel, fused_mel
from audax_torch.ops.mel import (fft_frontend_constants, fft_twiddles,
                                 fft_twiddles_400, frontend_constants,
                                 mel_bin_ranges)

from .test_torch_logmel_direct import CONFIGS, TOL, _jax_frontend

POW2 = {n: kw for n, kw in CONFIGS.items()
        if direct_mel.fft_applicable(MelConfig(**kw).n_fft, 1.0)}


def _signal(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (0.2 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(3 * t))
         + 0.1 * rng.standard_normal(n))
    return x.astype(np.float32)


def _fft_logmel(frames, window, fb, ranges, power):
    """The FFT body's arithmetic in numpy, float32: rfft of the windowed
    frame, |X|^power, each band over its bin range, log(x + 1e-6)."""
    spec = np.fft.rfft(frames * window).astype(np.complex64)
    p = (spec.real * spec.real + spec.imag * spec.imag).astype(np.float32)
    if power != 2.0:
        p = np.sqrt(np.maximum(p, 0.0)) ** np.float32(power)
    mel = np.zeros((len(frames), fb.shape[1]), np.float32)
    for m, (lo, hi) in enumerate(ranges):
        mel[:, m] = p[:, lo:hi] @ fb[lo:hi, m]
    return np.log(mel + np.float32(1e-6))


def test_every_power_of_two_config_is_covered():
    # every n_fft of the direct tiers' configs -- 512, 1024 and Whisper's
    # 400 -- is one the FFT body is built for
    assert set(POW2) == set(CONFIGS)


@pytest.mark.parametrize("name", sorted(POW2))
def test_window_is_the_bases_window(name):
    cfg = MelConfig(**POW2[name])
    window, fb, _, tw = fft_frontend_constants(cfg)
    cos_w, _, fb_direct = frontend_constants(cfg)
    assert window.dtype == np.float32 and window.shape == (cfg.n_fft,)
    np.testing.assert_array_equal(window, cos_w[:, 0])
    np.testing.assert_array_equal(fb, fb_direct)
    assert tw.dtype == np.float32 and tw.shape == (cfg.n_fft + 1, 2)
    table = fft_twiddles_400 if cfg.n_fft == 400 else fft_twiddles
    np.testing.assert_array_equal(tw, table(cfg.n_fft))


@pytest.mark.parametrize("name", sorted(POW2))
def test_bin_ranges_cover_every_nonzero(name):
    cfg = MelConfig(**POW2[name])
    _, fb, ranges, _ = fft_frontend_constants(cfg)
    assert ranges.dtype == np.int32 and ranges.shape == (cfg.n_mels, 2)
    k = np.arange(fb.shape[0])[:, None]
    inside = (k >= ranges[:, 0]) & (k < ranges[:, 1])
    assert not (fb[~inside] != 0).any()
    # tight: a band with weights starts and ends its range on one; a band
    # without (too narrow to hold a bin) has the empty range [0, 0)
    full = (fb != 0).any(axis=0)
    cols = np.arange(cfg.n_mels)[full]
    assert (fb[ranges[full, 0], cols] != 0).all()
    assert (fb[ranges[full, 1] - 1, cols] != 0).all()
    assert (ranges[~full] == 0).all()


def test_bin_ranges_of_dense_and_empty_filterbanks():
    dense = np.full((513, 7), 0.5, np.float32)
    np.testing.assert_array_equal(mel_bin_ranges(dense), [[0, 513]] * 7)
    fb = np.zeros((9, 3), np.float32)
    fb[2:5, 1] = 1.0
    fb[8, 2] = 1.0
    np.testing.assert_array_equal(mel_bin_ranges(fb),
                                  [[0, 0], [2, 5], [8, 9]])


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
@pytest.mark.parametrize("power", [1.0, 1.5])
def test_fft_formulation_matches_pallas(n_fft, power):
    kw = dict(n_fft=n_fft, hop_length=n_fft // 4, power=power)
    cfg, jcfg = MelConfig(**kw), JaxMelConfig(**kw)
    frames = np.array(frame_signal(jnp.asarray(_signal(n_fft, 6000)),
                                   jcfg)).reshape(-1, n_fft)
    cos_w, sin_w, fb = frontend_constants(cfg)
    ref = np.asarray(fused_logmel_frames(
        *(jnp.asarray(a) for a in (frames, cos_w, sin_w, fb)),
        power=power, interpret=True))[: len(frames), : cfg.n_mels]
    window, fb, ranges, tw = fft_frontend_constants(cfg)
    ours = _fft_logmel(frames, window, fb, ranges, power)
    assert ours.shape == ref.shape == (len(frames), cfg.n_mels)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    plain = direct_mel.fused_logmel_fft_plain(
        *(torch.from_numpy(a) for a in (frames, window, fb, ranges, tw)),
        "log1e6", power).numpy()
    np.testing.assert_allclose(plain, ref, atol=TOL, rtol=0)


def _kernel_schedule(x, window, tw):
    """``csrc/log_mel_fft.cu``'s FFT of one frame, lane by lane: a P-point
    radix-2 DIF over each lane's registers, the twiddles W_L^(j k2), a
    32-point radix-2 DIF across the lanes, then the real split."""
    n = len(x)
    half = n // 2
    p = half // 32
    w = tw[:, 0] + 1j * tw[:, 1]
    lane_tw, post = w[: p * 32], w[p * 32:]

    def rev(i, bits):
        return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0

    lanes = np.arange(32)
    idx = 2 * (lanes[:, None] + 32 * np.arange(p)[None, :])
    z = (x[idx] * window[idx] + 1j * x[idx + 1] * window[idx + 1]
         ).astype(np.complex64)
    st = 1
    while st < p:
        h = p // (2 * st)
        for i in range(p):
            if not i & h:
                a, b = z[:, i].copy(), z[:, i + h].copy()
                z[:, i], z[:, i + h] = a + b, a - b
                z[:, i + h] *= post[(i % h) * (n // (2 * h))]
        st *= 2
    bits = p.bit_length() - 1
    for i in range(1, p):
        z[:, i] *= lane_tw[rev(i, bits) * 32 + lanes]
    for s in range(5):
        h = 16 >> s
        up = (lanes & h) != 0
        tw_s = np.where(up, post[(lanes % h) * (n // (2 * h))], 1)
        z = (np.where(up, -1, 1)[:, None] * z + z[lanes ^ h]) * tw_s[:, None]
    spec = np.empty(half, np.complex64)
    for i in range(p):
        spec[rev(i, bits) + p * np.array([rev(j, 5) for j in lanes])] = z[:, i]
    k = np.arange(half + 1)
    a, b = spec[k % half], np.conj(spec[(half - k) % half])
    return 0.5 * (a + b) + post * (a - b) / 2j


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_kernel_schedule_and_twiddles_give_rfft(n_fft):
    window, _, _, tw = fft_frontend_constants(MelConfig(n_fft=n_fft))
    x = _signal(n_fft + 1, n_fft)
    ref = np.fft.rfft(x.astype(np.float64) * window)
    got = _kernel_schedule(x, window, tw)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,power,tier", [
    (1024, 1.0, "fft"), (1024, 1.5, "fft"), (256, 1.0, "fft"),
    (512, 0.5, "fft"), (2048, 1.0, "fft"), (400, 1.0, "fft"),
    (128, 1.0, "direct"), (4096, 1.0, "direct"), (1000, 1.5, "direct"),
    (1024, 2.0, "power 2"), (400, 2.0, "power 2"),
])
def test_fft_applicable_routes_each_config(n_fft, power, tier):
    want = tier == "fft"
    assert direct_mel.fft_applicable(n_fft, power) is want


@pytest.mark.parametrize("kw,body", [
    (dict(power=1.0), "fft"),
    (dict(n_fft=2048, hop_length=512, power=1.5, center=False), "fft"),
    (dict(n_fft=400, hop_length=160, power=1.0), "fft"),
])
def test_dispatcher_follows_the_route_on_cpu(kw, body):
    counters = (direct_mel.fused_logmel_fft_plain,
                direct_mel.fused_logmel_frames_plain)
    before = [c.launches for c in counters]
    x = torch.from_numpy(_signal(3, 5000)[None])
    mel = LogMelFrontend(MelConfig(**kw), device="cpu")(x)
    ran = [c.launches - b for c, b in zip(counters, before)]
    assert ran == ([1, 0] if body == "fft" else [0, 1])
    assert torch.isfinite(mel).all()


def test_fft_plain_equals_direct_plain_on_cpu():
    """The body's plain version and the direct body's compute the same
    function (the card holds the kernel against the latter)."""
    cfg = MelConfig(n_fft=512, hop_length=160, n_mels=80, power=1.5,
                    log_mode="log10")
    x = torch.from_numpy(np.stack([_signal(5, 8000), np.zeros(8000,
                                                              np.float32)]))
    frames, _ = fused_mel.direct_frames(x, cfg)
    got = direct_mel.fused_logmel_fft_plain(
        frames, *fused_mel.fft_constants(cfg, x.device), "log10", 1.5)
    ref = direct_mel.fused_logmel_frames_plain(
        frames, *fused_mel.direct_constants(cfg, x.device), "log10", 1.5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)
    assert (got[1] == -10.0).all()          # a silent clip: the log10 floor


def test_fft_cuda_wrapper_refuses_cpu_tensors_and_other_sizes():
    cfg = MelConfig(power=1.0)
    consts = fused_mel.fft_constants(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        direct_mel.fused_logmel_fft_cuda(torch.zeros(4, 1024), *consts)
    with pytest.raises(ValueError, match="n_fft"):
        direct_mel.fused_logmel_fft_cuda(torch.zeros(4, 480), *consts)


@pytest.mark.parametrize("power", [1.0, 1.5])
def test_n_fft_400_fft_body_matches_the_jax_generic_tier(power):
    """A magnitude mel (power 1) and a power-1.5 mel at Whisper's STFT
    geometry run the FFT body's plain version on the CPU, by the route the
    card takes, and match JAX's generic tier (``fused_logmel_frames`` in
    interpret mode) within 2e-3, the frontend bound."""
    kw = dict(n_fft=400, hop_length=160, power=power)
    cfg, jcfg = MelConfig(**kw), JaxMelConfig(**kw)
    assert fused_mel.mel_body(cfg) == "log_mel_fft"
    x = np.stack([_signal(13, 8000), _signal(14, 8000)])
    before = direct_mel.fused_logmel_fft_plain.launches
    ours = LogMelFrontend(cfg, device="cpu")(x).numpy()
    assert direct_mel.fused_logmel_fft_plain.launches == before + 1
    ref = _jax_frontend(x, jcfg)
    assert ours.shape == ref.shape == (2, cfg.frames_for(8000), cfg.n_mels)
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=0)
