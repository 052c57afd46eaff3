"""Port direct log-mel tiers (K4 packed, K5 generic) vs the JAX package on
the CPU.

The Pallas kernels run in interpret mode; the port's CPU path runs the
kernels' plain versions. Inputs come from a numpy seed. Tolerance 2e-4 in
the log domain: both sides are float32 products in different summation
orders, and a low bin's log moves by its relative rounding error
(measured against a float64 oracle: ~1e-4 on either side at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import MelConfig as JaxMelConfig
from audax.ops.mel import frontend_constants as jax_frontend_constants
from audax.ops.mel import packed_frontend_constants as jax_packed_constants
from audax.ops.pallas_mel import (fused_logmel_frames, fused_logmel_packed,
                                  log_mel_pallas, whisper_post_clamp)
from audax.ops.stft import frame_signal
from audax_torch.core.config import MelConfig
from audax_torch.frontend import LogMelFrontend
from audax_torch.ops import direct_mel, fused_mel
from audax_torch.ops.mel import frontend_constants, packed_frontend_constants

TOL = 2e-4

#: PANNs Cnn14_16k's frontend geometry: power 2, g = 32, a = 5 -> K4
PANNS = dict(n_fft=512, hop_length=160, n_mels=64, fmin=50.0, fmax=8000.0,
             htk=False, norm_slaney=True)
#: UrbanSound v2 as a magnitude mel (power 1) -> K5
MAGNITUDE = dict(power=1.0)
CONFIGS = {
    "panns": PANNS,
    "magnitude_v2": MAGNITUDE,
    "short_window": dict(n_fft=512, win_length=400, hop_length=160),
    "log10": dict(n_fft=512, hop_length=160, n_mels=80, log_mode="log10"),
    "whisper_mode": dict(n_fft=512, hop_length=160, n_mels=80, htk=False,
                         norm_slaney=True, log_mode="whisper"),
    "no_center": dict(n_fft=512, hop_length=160, center=False),
    "power_1_5_log10": dict(n_fft=400, hop_length=160, n_mels=80, power=1.5,
                            log_mode="log10"),
}


def _signal(rng, shape):
    n = shape[-1]
    t = np.arange(n) / 16000.0
    x = (0.2 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(3 * t))
         + 0.1 * rng.standard_normal(shape))
    return x.astype(np.float32)


def _jax_frontend(x, jcfg, whisper_frames=False):
    """JAX's ``log_mel_pallas`` in interpret mode, with the Whisper frame
    trim before the clamp as ``audax/frontend/features.py`` applies it."""
    mel = log_mel_pallas(jnp.asarray(x), jcfg, interpret=True,
                         whisper_post=not whisper_frames)
    if whisper_frames:
        mel = mel[..., :-1, :]
        if jcfg.log_mode == "whisper":
            mel = whisper_post_clamp(mel)
    return np.asarray(mel)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_constants_bit_identical(name):
    cfg, jcfg = MelConfig(**CONFIGS[name]), JaxMelConfig(**CONFIGS[name])
    for ours, ref in zip(packed_frontend_constants(cfg) +
                         frontend_constants(cfg),
                         jax_packed_constants(jcfg) +
                         jax_frontend_constants(jcfg)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["log1e6", "log10"])
def test_packed_plain_matches_pallas(mode, rng):
    cfg, jcfg = MelConfig(**PANNS), JaxMelConfig(**PANNS)
    x = _signal(rng, (1, 8000))
    frames = np.array(frame_signal(jnp.asarray(x), jcfg)).reshape(-1, 512)
    dft, fb2 = packed_frontend_constants(cfg)
    ref = np.asarray(fused_logmel_packed(
        jnp.asarray(frames), jnp.asarray(dft), jnp.asarray(fb2),
        log_mode=mode, interpret=True))[: len(frames), : cfg.n_mels]
    ours = direct_mel.fused_logmel_packed_plain(
        torch.from_numpy(frames), torch.from_numpy(dft),
        torch.from_numpy(fb2), mode).numpy()
    assert ours.shape == ref.shape == (51, 64)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("power", [1.0, 1.5])
def test_generic_plain_matches_pallas(power, rng):
    cfg = MelConfig(power=power)
    x = _signal(rng, (1, 6000))
    frames = np.array(frame_signal(jnp.asarray(x), JaxMelConfig(power=power)))
    frames = frames.reshape(-1, 1024)
    cos_w, sin_w, fb = frontend_constants(cfg)
    ref = np.asarray(fused_logmel_frames(
        *(jnp.asarray(a) for a in (frames, cos_w, sin_w, fb)),
        power=power, interpret=True))[: len(frames), : cfg.n_mels]
    ours = direct_mel.fused_logmel_frames_plain(
        *(torch.from_numpy(a) for a in (frames, cos_w, sin_w, fb)),
        "log1e6", power).numpy()
    assert ours.shape == ref.shape == (47, 128)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_frontend_matches_log_mel_pallas(name, rng):
    cfg, jcfg = MelConfig(**CONFIGS[name]), JaxMelConfig(**CONFIGS[name])
    x = _signal(rng, (2, 8001))                       # odd length
    ours = LogMelFrontend(cfg, device="cpu")(x).numpy()
    ref = _jax_frontend(x, jcfg)
    assert ours.shape == ref.shape == (2, cfg.frames_for(8001), cfg.n_mels)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("whisper_frames", [True, False])
def test_whisper_mode_frame_trim(whisper_frames, rng):
    kw = CONFIGS["whisper_mode"]
    cfg, jcfg = MelConfig(**kw), JaxMelConfig(**kw)
    x = _signal(rng, (1, 16000))
    x[0, -40:] *= 50.0          # a loud tail: the trimmed frame must not
    fe = LogMelFrontend(cfg, device="cpu", whisper_frames=whisper_frames)
    ours = fe(x).numpy()        # set the clamp floor
    ref = _jax_frontend(x, jcfg, whisper_frames)
    assert ours.shape == ref.shape == (1, fe.num_frames(16000), 80)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["panns", "magnitude_v2"])
def test_batch_rank_silence_and_sub_window(name, rng):
    cfg, jcfg = MelConfig(**CONFIGS[name]), JaxMelConfig(**CONFIGS[name])
    x = _signal(rng, (2, 3, 4000))
    x[1, 2] = 0.0                                     # one silent clip
    ours = LogMelFrontend(cfg, device="cpu")(x).numpy()
    ref = _jax_frontend(x, jcfg)
    assert ours.shape == ref.shape == (2, 3, cfg.frames_for(4000),
                                       cfg.n_mels)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[1, 2], np.log(1e-6), atol=1e-6)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    # center=False with a clip shorter than one window: zero frames
    short = MelConfig(**{**CONFIGS[name], "center": False})
    out = LogMelFrontend(short, device="cpu")(x[..., :100])
    assert tuple(out.shape) == (2, 3, 0, cfg.n_mels)


def test_cpu_tensor_reaches_the_direct_plain_versions(rng):
    """A non-overlap config on a CPU tensor runs K4's (power 2) or K5's
    (power != 2) plain version -- K5's FFT body's for an n_fft the FFT body
    is built for (Whisper's 400 among them), its direct body's for any
    other -- never the overlap tier."""
    x = torch.from_numpy(_signal(rng, (1, 4000)))
    counters = (direct_mel.fused_logmel_packed_plain,
                direct_mel.fused_logmel_frames_plain,
                fused_mel.log_mel_overlap_plain,
                direct_mel.fused_logmel_fft_plain)
    for kw, want in ((PANNS, (1, 0, 0, 0)), (MAGNITUDE, (0, 0, 0, 1)),
                     (CONFIGS["power_1_5_log10"], (0, 0, 0, 1)),
                     (dict(n_fft=1000, hop_length=160, power=1.5),
                      (0, 1, 0, 0)),
                     ({}, (0, 0, 1, 0))):
        before = [f.launches for f in counters]
        LogMelFrontend(MelConfig(**kw), device="cpu")(x)
        assert tuple(f.launches - b for f, b in zip(counters, before)) == want


def test_cuda_wrappers_refuse_cpu_tensors():
    frames = torch.zeros(4, 512)
    dft, fb2 = (torch.from_numpy(a) for a in
                packed_frontend_constants(MelConfig(**PANNS)))
    with pytest.raises(ValueError, match="CUDA"):
        direct_mel.fused_logmel_packed_cuda(frames, dft, fb2)
