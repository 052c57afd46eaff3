"""The port's profiling utilities on the CPU (``audax_torch.utils.profiling``).

On the CPU the slope timers take ``time.perf_counter`` slopes of eager
loops and ``time_fn`` runs without a device to synchronize: each must
return a positive, finite time per call, as ``tests/test_aux.py`` pins for
the JAX versions. The CUDA-graph path runs on the card only
(``chip_smoke.py``'s probes phase drives it through the int4 tools).
"""

import json
import math

import torch

from audax_torch.utils import profiling as P


def _matmul(a, w):
    return a @ w


def test_slope_timed_positive_finite():
    a, w = torch.randn(128, 128), torch.randn(128, 128)
    sec = P.slope_timed(_matmul, (a, w), iters=(10, 110), repeats=3)
    assert math.isfinite(sec) and sec > 0


def test_slope_timed_chained_positive_finite():
    w = torch.eye(128) * 0.5
    seen = []

    def step(x, w_):
        assert w_ is w                        # extra args pass through
        seen.append(1)
        return x @ w_ + 1.0
    sec = P.slope_timed_chained(step, torch.ones(128, 128), (w,),
                                iters=(10, 110), repeats=3)
    assert math.isfinite(sec) and sec > 0
    # each length once to warm up, then ``repeats`` timed runs
    assert len(seen) == (1 + 3) * (10 + 110)


def test_time_fn_positive():
    t = P.time_fn(_matmul, torch.ones(64, 64), torch.ones(64, 64), iters=5)
    assert t["seconds_per_call"] > 0 and t["calls_per_second"] > 0
    assert math.isfinite(t["seconds_per_call"])


def test_step_flops_counts_a_matmul():
    assert P.flops_estimate_matmul(8, 16, 32) == 2 * 8 * 16 * 32
    flops = P.step_flops(_matmul, torch.ones(8, 32), torch.ones(32, 16))
    assert flops == P.flops_estimate_matmul(8, 16, 32)


def test_mfu_against_h100_peaks():
    out = P.mfu(989e12, 1.0)
    assert out == {"achieved_tflops": 989.0, "mfu_pct": 100.0}
    assert P.mfu(67e12, 1.0, peak=P.H100_F32_FLOPS)["mfu_pct"] == 100.0
    assert P.mfu(0.0, 1.0) == {"achieved_tflops": 0.0, "mfu_pct": 0.0}


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        _matmul(torch.ones(32, 32), torch.ones(32, 32))
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]
