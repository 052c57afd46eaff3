"""Model FLOPs and kernels' least times against hand-worked shapes."""

import json

import pytest
import torch

from benchmark.lib import flops
from benchmark.lib.readers import roofline
from tiny import ROOT

PEAKS = json.loads((ROOT / "benchmark/peaks.json").read_text())
SMALL = json.loads((ROOT / "benchmark/configs/whisper-small.json").read_text())
TURBO = json.loads((ROOT / "benchmark/configs/whisper-large-v3-turbo.json")
                   .read_text())


def test_encoder_forward_by_hand():
    # whisper-small, one clip: stem 2*3000*768*240 + 2*1500*768*2304;
    # a layer 8*1500*768^2 + 4*1500*768*3072 + 4*1500^2*768
    stem = 2 * 3000 * 768 * 240 + 2 * 1500 * 768 * 2304
    layer = 8 * 1500 * 768 ** 2 + 4 * 1500 * 768 * 3072 + 4 * 1500 ** 2 * 768
    assert flops.encoder_fwd(SMALL, 2) == 2 * (stem + 12 * layer)


def test_train_step_is_three_forwards_whatever_remat():
    f = flops.encoder_fwd(SMALL, 16) + flops.decoder_fwd(SMALL, 16, 104)
    assert flops.train_step(SMALL, 16, 104) == pytest.approx(3 * f)


def test_turbo_clip_is_2_27_tflop():
    assert flops.encoder_fwd(TURBO) / 1e12 == pytest.approx(2.274, abs=0.001)


def test_decode_positions_sum_of_single_positions():
    one = [flops.decode_positions(TURBO, n + 1) - flops.decode_positions(
        TURBO, n) for n in range(5)]
    d, s, v = 1280, 1500, 51866
    # position p: 4 layers * (12 d^2 + 4 d ff + 4 d (p + 1) + 4 s d) + 2 d V
    for p, got in enumerate(one):
        want = 4 * (12 * d * d + 4 * d * 5120 + 4 * d * (p + 1)
                    + 4 * s * d) + 2 * d * v
        assert got == want


def test_flash_fwd_least_time_by_hand():
    mod = roofline("flash_fwd")
    q = torch.empty(8, 20, 1500, 64, dtype=torch.bfloat16)
    c = mod.record(q, q, q, causal=False)
    ops = 4 * 8 * 20 * 64 * 1500 * 1500
    assert mod.flops(c) == ops
    assert mod.nbytes(c) == 4 * 8 * 20 * 1500 * 64 * 2 + 4 * 8 * 20 * 1500
    assert mod.least_seconds([c], PEAKS) == pytest.approx(ops / 989e12)
    causal = mod.record(q, q, q, causal=True)
    assert mod.flops(causal) == 4 * 8 * 20 * 64 * (1500 * 1501 // 2)


def test_flash_bwd_is_five_products():
    mod = roofline("flash_bwd")
    q = torch.empty(16, 12, 1500, 64, dtype=torch.bfloat16)
    c = mod.record(q, q, q, q, None, q, causal=False)
    ops = 2.5 * 4 * 16 * 12 * 64 * 1500 ** 2
    assert mod.least_seconds([c], PEAKS) == pytest.approx(ops / 989e12)
    assert mod.LAUNCHES_PER_CALL == 2


def test_decode_attn_counts_the_keys_each_slot_reads():
    mod = roofline("decode_attn")
    q = torch.empty(3, 20, 1, 64, dtype=torch.bfloat16)
    cache = torch.empty(4, 3, 20, 228, 64, dtype=torch.bfloat16)
    pos = torch.tensor([0, 9, 99], dtype=torch.int32)
    c = mod.record(q, (cache, cache), 0, pos=pos)
    keys = 1 + 10 + 100
    nbytes = keys * 20 * 64 * 2 * 2 + 2 * 3 * 20 * 64 * 2
    assert mod.least_seconds([c], PEAKS) == pytest.approx(nbytes / 3.35e12)
    cross = mod.record(q, (torch.empty(4, 3, 20, 1500, 64,
                                       dtype=torch.bfloat16),) * 2, 0)
    nbytes = 3 * 1500 * 20 * 64 * 2 * 2 + 2 * 3 * 20 * 64 * 2
    assert mod.least_seconds([cross], PEAKS) == pytest.approx(
        nbytes / 3.35e12)
