"""K1's and K4's tiers on the FFT body (``csrc/log_mel_fft.cu`` at power 2)
on the CPU: the 400-point mixed radix, the body table, and the power-2
formulation against the JAX package.

* The kernel's n_fft-400 schedule, transcribed lane by lane into numpy with
  the twiddle table the kernel reads (``ops/mel.py:fft_twiddles_400``): an
  8-point radix-2 DIF in each lane's registers, the twiddles W_200^(j k2),
  two radix-5 stages across 25 lanes by shuffles from arbitrary lanes
  (lanes 25-31 idle, carrying zeros), the base-5 digit-reversed spectrum,
  then the real split: it equals numpy's float64 ``rfft`` of the windowed
  frame within 1e-6 of its largest bin.
* ``fused_mel.BODIES``/``mel_body``: Whisper 80/128, UrbanSound v1/v2 and
  PANNs go to the FFT body on the card; n_fft 480 hop 160 stays on the
  overlap kernel, n_fft 1000 hop 160 on the packed kernel, a magnitude mel
  at n_fft 400 on K5's FFT body too (K5's route is ``fft_applicable``),
  at n_fft 1000 on K5's direct body. The source's lane split and shared
  memory fit every size the
  table names (``test_torch_exports.py`` holds the table against the
  counters and the source's instantiations).
* The power-2 FFT formulation (``fused_logmel_fft_plain`` on the constants
  of ``fft_frontend_constants``) against JAX within 2e-3 in the log domain
  (the frontend bound, ``test_torch_frontend.py``): ``log_mel_overlap`` at
  Whisper 80/128 and UrbanSound v2, ``fused_logmel_packed`` at PANNs, each
  Pallas kernel in interpret mode.
* On a CPU tensor the tiers keep their own plain versions, and the new
  CUDA entry points refuse CPU tensors and n_fft values off the table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import MelConfig as JaxMelConfig
from audax.ops.pallas_mel import fused_logmel_packed, log_mel_overlap
from audax.ops.stft import frame_signal
from audax_torch.core.config import MelConfig
from audax_torch.frontend import LogMelFrontend
from audax_torch.ops import direct_mel, fused_mel
from audax_torch.ops.mel import (fft_frontend_constants, fft_twiddles,
                                 fft_twiddles_400, hann_window,
                                 packed_frontend_constants)

from .csrc_constexpr import constexpr_function

TOL = 2e-3
PANNS = dict(n_fft=512, hop_length=160, n_mels=64, fmin=50.0, fmax=8000.0,
             htk=False, norm_slaney=True)
#: (config, the kernel mel_body names on the card)
ROUTES = {
    "whisper": (MelConfig.whisper(), "log_mel_overlap_fft"),
    "whisper_128": (MelConfig.whisper(128), "log_mel_overlap_fft"),
    "urbansound_v2": (MelConfig.urbansound_v2(), "log_mel_overlap_fft"),
    "urbansound_v1": (MelConfig.urbansound_v1(), "log_mel_overlap_fft"),
    "panns": (MelConfig(**PANNS), "log_mel_packed_fft"),
    "n_fft_480": (MelConfig(n_fft=480, hop_length=160), "log_mel_overlap"),
    "n_fft_1000": (MelConfig(n_fft=1000, hop_length=160), "log_mel_packed"),
    "n_fft_400_win_320": (MelConfig(n_fft=400, win_length=320,
                                    hop_length=160), "log_mel_packed_fft"),
    "magnitude_400": (MelConfig(n_fft=400, hop_length=160, power=1.0),
                      "log_mel_fft"),
    "magnitude_1000": (MelConfig(n_fft=1000, hop_length=160, power=1.0),
                       "log_mel_generic"),
    "magnitude_v2": (MelConfig(power=1.0), "log_mel_fft"),
    "power_1_5_n_fft_2048": (MelConfig(n_fft=2048, hop_length=512,
                                       power=1.5), "log_mel_fft"),
}


def _signal(seed, shape):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    x = (0.2 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(3 * t))
         + 0.1 * rng.standard_normal(shape))
    return x.astype(np.float32)


def _kernel_schedule_400(x, window, tw):
    """``csrc/log_mel_fft.cu``'s FFT of one 400-sample frame, lane by lane
    over a warp of 32: lane j < 25 holds z[j + 25 p] (p < 8); returns the
    401 bins and the lanes' values after the lane stages."""
    n, half, lanes, p, radix = 400, 200, 25, 8, 5
    w = tw[:, 0] + 1j * tw[:, 1]
    lane_tw, post = w[:half], w[half:]

    def root(k):                        # W_N^k from W_N^0 .. W_N^(N/2)
        k = k % n
        return np.where(k <= half, post[np.minimum(k, half)],
                        np.conj(post[np.clip(n - k, 0, half)]))

    def rev3(i):
        return int(format(i, "03b")[::-1], 2)

    lane = np.arange(32)
    holds = lane < lanes
    m = np.where(holds[:, None], lane[:, None] + lanes * np.arange(p), 0)
    z = np.where(holds[:, None], x[2 * m] * window[2 * m]
                 + 1j * x[2 * m + 1] * window[2 * m + 1], 0
                 ).astype(np.complex64)
    st = 1                              # 8-point radix-2 DIF in registers
    while st < p:
        h = p // (2 * st)
        for i in range(p):
            if not i & h:
                a, b = z[:, i].copy(), z[:, i + h].copy()
                z[:, i], z[:, i + h] = a + b, a - b
                z[:, i + h] *= post[(i % h) * (n // (2 * h))]
        st *= 2
    for i in range(1, p):               # W_200^(j k2), register i = bin rev3
        z[:, i] *= lane_tw[rev3(i) * lanes + np.where(holds, lane, 0)]
    u, v = lane % radix, lane // radix
    s = np.arange(radix)
    # stage 1: lane u + 5v sums lanes u + 5s by W_5^(s v), then W_25^(u v)
    r1 = np.where(holds[:, None], root(n // radix * (s * v[:, None] % radix)),
                  0)
    t1 = np.where(holds, root(n // radix ** 2 * (u * v)), 0)
    z = sum(z[(u + radix * k) % 32] * r1[:, k, None] for k in s)
    z = z * t1[:, None]
    # stage 2: lane u + 5v sums lanes 5v + s by W_5^(s u)
    r2 = np.where(holds[:, None], root(n // radix * (s * u[:, None] % radix)),
                  0)
    z = sum(z[(radix * v + k) % 32] * r2[:, k, None] for k in s)
    k1 = v + radix * u                   # base-5 digits reversed
    spec = np.empty(half, np.complex64)
    for i in range(p):
        spec[rev3(i) + p * k1[holds]] = z[holds, i]
    k = np.arange(half + 1)
    a, b = spec[k % half], np.conj(spec[(half - k) % half])
    return 0.5 * (a + b) + post * (a - b) / 2j, z


@pytest.mark.parametrize("win,seed", [(400, 0), (400, 1), (320, 2),
                                      (320, 3)])
def test_kernel_schedule_400_gives_rfft(win, seed):
    window, _, _, tw = fft_frontend_constants(
        MelConfig(n_fft=400, win_length=win, hop_length=160))
    x = _signal(seed, (400,))
    ref = np.fft.rfft(x.astype(np.float64) * window)
    got, lanes = _kernel_schedule_400(x, window, tw)
    assert got.shape == (201,)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert (lanes[25:] == 0).all()      # idle lanes carry zeros


def test_twiddles_400_layout_and_values():
    tw = fft_twiddles_400()
    assert tw.dtype == np.float32 and tw.shape == (401, 2)
    # W_200^(j k2) at row k2 * 25 + j, then W_400^k for k = 0 .. 200, each
    # the float64 value rounded once
    j, k2 = np.meshgrid(np.arange(25), np.arange(8))
    ang = np.concatenate([(2 * np.pi * j * k2 / 200).reshape(-1),
                          2 * np.pi * np.arange(201) / 400])
    want = np.stack([np.cos(ang), -np.sin(ang)], 1).astype(np.float32)
    np.testing.assert_array_equal(tw, want)
    assert tw[3 * 25 + 7, 0] == np.float32(np.cos(2 * np.pi * 21 / 200))
    np.testing.assert_array_equal(
        fft_frontend_constants(MelConfig.whisper())[3], tw)


@pytest.mark.parametrize("n_fft", [256, 399, 512, 800, 1024])
def test_twiddles_400_refuses_other_sizes(n_fft):
    with pytest.raises(ValueError, match="400"):
        fft_twiddles_400(n_fft)


@pytest.mark.parametrize("n_fft", [400, 480, 1000])
def test_power_of_two_twiddles_still_refuse(n_fft):
    with pytest.raises(ValueError, match="power of two"):
        fft_twiddles(n_fft)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_body_table_routes_each_config(name):
    cfg, body = ROUTES[name]
    assert fused_mel.mel_body(cfg) == body
    tier = fused_mel.mel_tier(cfg)
    assert body in fused_mel.BODIES[tier][1:]
    if tier == "generic":               # K5's route is unchanged
        want = "log_mel_fft" if direct_mel.fft_applicable(
            cfg.n_fft, cfg.power) else "log_mel_generic"
        assert body == want


@pytest.mark.parametrize("n_fft", direct_mel.FFT_SIZES)
def test_source_lanes_and_shared_memory(n_fft):
    """The source's lane split matches the twiddle table's layout, and the
    widest tile (256 bands) fits one block's shared memory."""
    lanes = constexpr_function("log_mel_fft.cu", "lanes_of")(n_fft)
    points = n_fft // 2 // lanes
    assert points * lanes == n_fft // 2 and points & (points - 1) == 0
    assert lanes == (25 if n_fft == 400 else 32)
    tw = fft_frontend_constants(MelConfig(n_fft=n_fft))[3]
    assert tw.shape == (points * lanes + n_fft // 2 + 1, 2)
    smem = constexpr_function("log_mel_fft.cu", "smem_floats")
    assert 4 * smem(n_fft, direct_mel.MAX_MELS) <= 232448
    assert smem(400, 80) == 8 * 201 + 8 * 2 * (200 + 200 // 32)


@pytest.mark.parametrize("name,jcfg,n", [
    ("whisper", JaxMelConfig.whisper(), 8000),
    ("whisper_128", JaxMelConfig.whisper(128), 8000),
    ("urbansound_v2", JaxMelConfig.urbansound_v2(), 6000),
])
def test_power2_fft_formulation_matches_overlap_pallas(name, jcfg, n):
    cfg = ROUTES[name][0]
    x = _signal(n, (2, n))
    ref = np.asarray(log_mel_overlap(jnp.asarray(x), jcfg, whisper_post=False,
                                     interpret=True))
    xt = torch.from_numpy(x)
    frames, _ = fused_mel.direct_frames(xt, cfg)
    mode = "log1e6" if cfg.log_mode == "log1e6" else "log10"
    ours = direct_mel.fused_logmel_fft_plain(
        frames, *fused_mel.fft_constants(cfg, xt.device), mode, 2.0).numpy()
    assert ours.shape == ref.shape == (2, cfg.frames_for(n), cfg.n_mels)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["log1e6", "log10"])
def test_power2_fft_formulation_matches_packed_pallas(mode):
    cfg, jcfg = MelConfig(**PANNS), JaxMelConfig(**PANNS)
    x = _signal(5, (1, 8000))
    frames = np.array(frame_signal(jnp.asarray(x), jcfg)).reshape(-1, 512)
    dft, fb2 = packed_frontend_constants(cfg)
    ref = np.asarray(fused_logmel_packed(
        jnp.asarray(frames), jnp.asarray(dft), jnp.asarray(fb2),
        log_mode=mode, interpret=True))[: len(frames), : cfg.n_mels]
    ours = direct_mel.fused_logmel_fft_plain(
        torch.from_numpy(frames),
        *fused_mel.fft_constants(cfg, torch.device("cpu")), mode,
        2.0).numpy()
    assert ours.shape == ref.shape == (51, 64)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_numpy_rfft_at_400_matches_the_plain_formulation():
    """The plain FFT formulation at n_fft 400 equals numpy's float64 rfft
    of the windowed frames to float32 rounding, power 2, log10."""
    cfg = MelConfig.whisper()
    x = torch.from_numpy(_signal(7, (1, 4000)))
    frames, _ = fused_mel.direct_frames(x, cfg)
    window, fb, ranges, tw = fused_mel.fft_constants(cfg, x.device)
    np.testing.assert_array_equal(window.numpy(), hann_window(400))
    got = direct_mel.fused_logmel_fft_plain(frames, window, fb, ranges, tw,
                                            "log10", 2.0).numpy()
    spec = np.fft.rfft(frames.numpy().astype(np.float64)
                       * window.numpy().astype(np.float64))
    mel = (np.abs(spec) ** 2) @ fb.numpy().astype(np.float64)
    np.testing.assert_allclose(got, np.log10(np.maximum(mel, 1e-10)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["whisper", "urbansound_v2", "panns",
                                  "n_fft_400_win_320"])
def test_cpu_tensor_keeps_the_tiers_plain_versions(name):
    cfg, _ = ROUTES[name]
    counters = (fused_mel.log_mel_overlap_plain,
                direct_mel.fused_logmel_packed_plain,
                direct_mel.fused_logmel_fft_plain,
                fused_mel.log_mel_overlap_fft_cuda,
                direct_mel.fused_logmel_packed_fft_cuda)
    before = [c.launches for c in counters]
    mel = LogMelFrontend(cfg, device="cpu")(_signal(11, (2, 4000)))
    ran = [c.launches - b for c, b in zip(counters, before)]
    tier = fused_mel.mel_tier(cfg)
    assert ran == [int(tier == "overlap"), int(tier == "packed"), 0, 0, 0]
    assert torch.isfinite(mel).all()


def test_fft_entry_points_refuse_cpu_tensors_and_sizes_off_the_table():
    cpu = torch.device("cpu")
    whisper = MelConfig.whisper()
    with pytest.raises(ValueError, match="CUDA"):
        fused_mel.log_mel_overlap_fft_cuda(torch.zeros(2, 4000), whisper)
    with pytest.raises(ValueError, match="n_fft 480"):
        fused_mel.log_mel_overlap_fft_cuda(
            torch.zeros(2, 4000), MelConfig(n_fft=480, hop_length=160))
    with pytest.raises(ValueError, match="n_fft"):     # K4's tier at 1000
        fused_mel.log_mel_overlap_fft_cuda(
            torch.zeros(2, 4000), MelConfig(n_fft=1000, hop_length=160))
    panns = MelConfig(**PANNS)
    consts = fused_mel.fft_constants(panns, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        direct_mel.fused_logmel_packed_fft_cuda(torch.zeros(4, 512), *consts)
    with pytest.raises(ValueError, match="n_fft"):
        direct_mel.fused_logmel_packed_fft_cuda(torch.zeros(4, 1000),
                                                *consts)
    # K5's FFT body takes Whisper's 400 too (a CPU tensor stops at the
    # device check), and nothing off the table
    with pytest.raises(ValueError, match="CUDA"):
        direct_mel.fused_logmel_fft_cuda(
            torch.zeros(4, 400), *fused_mel.fft_constants(whisper, cpu))
    with pytest.raises(ValueError, match="n_fft"):
        direct_mel.fused_logmel_fft_cuda(
            torch.zeros(4, 480), *fused_mel.fft_constants(whisper, cpu))
