"""More than 256 mel bands on every log-mel body, on the CPU.

* The port's frontend at 320 and 512 bands against the JAX frontend
  (``log_mel_pallas``, its Pallas kernels in interpret mode) on the same
  numpy signal, within 2e-3 in the log domain (the frontend bound): K1's
  tier at n_fft 1024, K4's at a power-2 config the overlap tier does not
  take (n_fft 1024 hop 160), K5 at n_fft 1024 (its FFT body) and 1000 (its
  direct body). On the CPU each runs its plain version; the card's bodies
  are held against those in ``chip_smoke.py``.
* ``direct_mel.band_chunks``, the plan the direct bodies launch by (one
  launch per chunk of at most 256 bands), covers every band once, in
  order.
* ``direct_mel.fft_smem_bytes`` is the source's ``smem_floats`` formula,
  and the FFT body's wrappers refuse a band count whose tile does not fit
  one block's shared memory before any launch, while a wide one that fits
  passes that check.
"""

import numpy as np
import pytest
import torch

from audax.core.config import MelConfig as JaxMelConfig
from audax_torch.core.config import MelConfig
from audax_torch.frontend import LogMelFrontend
from audax_torch.ops import direct_mel, fused_mel

from .csrc_constexpr import constexpr_function
from .test_torch_logmel_direct import _jax_frontend, _signal

TOL = 2e-3
#: (config keywords, the tier, the body the card runs)
CONFIGS = {
    "overlap_1024": (dict(n_fft=1024, hop_length=512), "overlap",
                     "log_mel_overlap_fft"),
    "packed_1024": (dict(n_fft=1024, hop_length=160), "packed",
                    "log_mel_packed_fft"),
    "magnitude_1024": (dict(n_fft=1024, hop_length=256, power=1.0),
                       "generic", "log_mel_fft"),
    "magnitude_1000": (dict(n_fft=1000, hop_length=250, power=1.0),
                       "generic", "log_mel_generic"),
}


@pytest.mark.parametrize("n_mels", [320, 512])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frontend_above_256_bands_matches_jax(name, n_mels, rng):
    kw, tier, body = CONFIGS[name]
    kw = dict(kw, n_mels=n_mels)
    cfg, jcfg = MelConfig(**kw), JaxMelConfig(**kw)
    assert (fused_mel.mel_tier(cfg), fused_mel.mel_body(cfg)) == (tier, body)
    x = _signal(rng, (2, 6000))
    ours = LogMelFrontend(cfg, device="cpu")(x).numpy()
    ref = _jax_frontend(x, jcfg)
    assert ours.shape == ref.shape == (2, cfg.frames_for(6000), n_mels)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_mels", [1, 80, 255, 256, 257, 320, 512, 513,
                                    1000])
def test_band_chunks_cover_every_band_once(n_mels):
    chunks = direct_mel.band_chunks(n_mels)
    covered = [m for lo, hi in chunks for m in range(lo, hi)]
    assert covered == list(range(n_mels))
    assert all(0 < hi - lo <= direct_mel.MAX_MELS for lo, hi in chunks)
    assert len(chunks) == -(-n_mels // direct_mel.MAX_MELS)
    with pytest.raises(ValueError):
        direct_mel.band_chunks(0)


@pytest.mark.parametrize("n_fft", direct_mel.FFT_SIZES)
def test_fft_smem_is_the_sources_formula(n_fft):
    smem_floats = constexpr_function("log_mel_fft.cu", "smem_floats")
    for n_mels in (1, 80, 128, 256, 257, 512, 1000, 4096, 8192):
        assert direct_mel.fft_smem_bytes(n_fft, n_mels) == 4 * smem_floats(
            n_fft, n_mels)
    # every band count up to 6000 fits one block at each built size
    assert direct_mel.fft_smem_bytes(n_fft, 6000) <= 232448


@pytest.mark.parametrize("n_fft,n_mels", [(1024, 7500), (400, 8000),
                                          (2048, 8192), (256, 9000)])
def test_fft_body_refuses_a_tile_past_shared_memory_before_launch(n_fft,
                                                                  n_mels):
    f = n_fft // 2 + 1
    window, twiddles = torch.zeros(n_fft), torch.zeros(n_fft + 1, 2)
    fb = torch.zeros(f, n_mels)
    ranges = torch.zeros(n_mels, 2, dtype=torch.int32)
    frames = torch.zeros(4, n_fft)
    counters = (direct_mel.fused_logmel_fft_cuda,
                direct_mel.fused_logmel_packed_fft_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="shared memory|mel bands"):
        direct_mel.fused_logmel_fft_cuda(frames, window, fb, ranges,
                                         twiddles, "log1e6", 1.0)
    with pytest.raises(ValueError, match="shared memory|mel bands"):
        direct_mel.fused_logmel_packed_fft_cuda(frames, window, fb, ranges,
                                                twiddles)
    assert [c.launches for c in counters] == before


def test_fft_body_takes_512_bands():
    """512 bands pass the band and shared-memory checks (the old 256-band
    bound is gone); a CPU tensor then stops at the device check."""
    cfg = MelConfig(n_fft=1024, hop_length=256, n_mels=512, power=1.0)
    consts = fused_mel.fft_constants(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        direct_mel.fused_logmel_fft_cuda(torch.zeros(4, 1024), *consts)
