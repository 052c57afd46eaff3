"""Port log-mel frontend vs the JAX package on the CPU.

The overlap kernel's plain version (``audax_torch.ops.fused_mel``) and the
direct-DFT twin (``audax_torch.ops.stft.log_mel_plain``) are held against
the JAX Pallas kernel in interpret mode and its XLA twin, for the Whisper
and UrbanSound v2 presets, at 2e-3 in the log domain (the frontend bound
the JAX package holds, bench.py:97-101).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import MelConfig as JaxMelConfig
from audax.frontend import LogMelFrontend as JaxFrontend
from audax.ops.pallas_mel import log_mel_pallas
from audax.ops.stft import log_mel_xla
from audax_torch.core.config import MelConfig
from audax_torch.frontend import LogMelFrontend, pad_or_trim
from audax_torch.ops.fused_mel import (log_mel_overlap, log_mel_overlap_plain,
                                       whisper_post_clamp)
from audax_torch.ops.stft import log_mel_plain

TOL = 2e-3
PRESETS = {
    "whisper": (MelConfig.whisper(), JaxMelConfig.whisper()),
    "urbansound_v2": (MelConfig.urbansound_v2(), JaxMelConfig.urbansound_v2()),
}


def _signal(rng, n, batch=2):
    t = np.arange(n) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 3333 * t)
         + 0.05 * rng.standard_normal((batch, n)))
    return x.astype(np.float32)


def _port_overlap(x, cfg):
    mel = log_mel_overlap(torch.from_numpy(x), cfg)
    if cfg.log_mode == "whisper":
        mel = whisper_post_clamp(mel)
    return mel.numpy()


@pytest.mark.parametrize("name", list(PRESETS))
def test_overlap_plain_matches_jax(name, rng):
    cfg, jcfg = PRESETS[name]
    x = _signal(rng, 16000)
    pallas = np.asarray(log_mel_pallas(jnp.asarray(x), jcfg, interpret=True))
    xla = np.asarray(log_mel_xla(jnp.asarray(x), jcfg))
    ours = _port_overlap(x, cfg)
    assert ours.shape == pallas.shape == (2, cfg.frames_for(16000), cfg.n_mels)
    np.testing.assert_allclose(ours, pallas, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(PRESETS))
def test_direct_plain_matches_jax_xla(name, rng):
    cfg, jcfg = PRESETS[name]
    x = _signal(rng, 12345)
    xla = np.asarray(log_mel_xla(jnp.asarray(x), jcfg))
    ours = log_mel_plain(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(ours, xla, atol=TOL, rtol=0)


def test_cpu_wrapper_takes_plain_version(rng):
    cfg = MelConfig.whisper()
    before = log_mel_overlap_plain.launches
    log_mel_overlap(torch.from_numpy(_signal(rng, 4000)), cfg)
    assert log_mel_overlap_plain.launches == before + 1


def test_whisper_frontend_frames_and_trim_then_clamp(rng):
    """30 s -> exactly 3000 frames, and the last STFT frame is dropped
    BEFORE the max-8 clamp: a loud final frame must not set the floor."""
    n = 480000
    x = (0.01 * rng.standard_normal(n)).astype(np.float32)
    # a burst at the very end: centred in the final (dropped) frame, at the
    # window's near-zero tail in the frame before it
    x[-16:] = 100.0 * np.sin(np.arange(16))
    fe = LogMelFrontend.whisper(device="cpu")
    mel = fe(x[None]).numpy()[0]
    assert mel.shape == (3000, 80) and fe.num_frames(n) == 3000
    raw = log_mel_overlap_plain(torch.from_numpy(x), fe.cfg)
    trimmed_first = whisper_post_clamp(raw[:-1]).numpy()
    clamped_first = whisper_post_clamp(raw)[:-1].numpy()
    np.testing.assert_array_equal(mel, trimmed_first)
    assert np.abs(mel - clamped_first).max() > 0.25
    ref = np.asarray(JaxFrontend.whisper(backend="xla")(jnp.asarray(x[None])))[0]
    np.testing.assert_allclose(mel, ref, atol=TOL, rtol=0)


def test_silent_input_stays_finite():
    x = np.zeros((1, 32000), np.float32)
    mel = LogMelFrontend.whisper(device="cpu")(x).numpy()
    assert np.isfinite(mel).all()
    ref = np.asarray(JaxFrontend.whisper(backend="xla")(jnp.asarray(x)))
    np.testing.assert_allclose(mel, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("version", [2, 1])
def test_urbansound_odd_length_clip(version, rng):
    """An odd-length clip (UrbanSound v1 runs the overlap kernel too: g=512,
    a=1), pad_or_trim to the 4 s contract, mel_first layout."""
    x = _signal(rng, 16001, batch=1)
    fe = LogMelFrontend.urbansound(version, device="cpu")
    jfe = JaxFrontend.urbansound(version, backend="xla")
    ours = fe(x, mel_first=True).numpy()
    ref = np.asarray(jfe(jnp.asarray(x), mel_first=True))
    assert ours.shape == ref.shape == (1, fe.cfg.n_mels, fe.num_frames(16001))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    padded = pad_or_trim(torch.from_numpy(x), 64000)
    assert padded.shape == (1, 64000) and float(padded[0, 16001:].abs().max()) == 0
    assert pad_or_trim(padded, 16001).shape == (1, 16001)


def test_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        LogMelFrontend.whisper()
