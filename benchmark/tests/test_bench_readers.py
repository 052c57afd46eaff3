"""The metric readers on a synthetic device trace and synthetic spans."""

import json

import pytest
import torch

from benchmark.lib.harness import Harness, metric_reader
from benchmark.lib.trace import DeviceTrace, Spans, breakdown
from tiny import ROOT

PEAKS = json.loads((ROOT / "benchmark/peaks.json").read_text())
TURBO = json.loads((ROOT / "benchmark/configs/whisper-large-v3-turbo.json")
                   .read_text())


def ctx(**kw):
    h = Harness(ROOT, "turbo-speech-backlog", 1, 10.0, True, device="cpu")
    return h.context(**kw)


def trace():
    # two kernels of K2 (1 ms each), one K3 (0.5 ms), one copy; busy 2.5 ms
    # of a 10 ms window, the longest gap (4 ms) before K3
    ops = [("void flash_fwd_sm90_kernel<64, 128, 1>(x)", 0.000, 0.001),
           ("void flash_fwd_sm90_kernel<64, 128, 1>(x)", 0.0015, 0.0025),
           ("decode_cluster_kernel<bf16>", 0.0065, 0.0070),
           ("Memcpy HtoD (Pageable -> Device)", 0.0070, 0.0070)]
    return DeviceTrace(ops, 0.010)


def test_idle_share_and_breakdown():
    t = trace()
    c = ctx(trace=t)
    assert metric_reader("device_idle_pct.rate").read(c) == \
        pytest.approx(75.0)
    spans = Spans()
    spans.add("engine.step", 0.002, 0.008)
    b = breakdown(t, spans)
    assert b["device_ops"][0] == ["void flash_fwd_sm90_kernel",
                                  pytest.approx(0.002)]
    assert b["idle_gaps"][0][0] == "engine.step before decode_cluster_kernel"
    assert b["idle_gaps"][0][1] == pytest.approx(0.004)


def test_roofline_share_from_calls_and_kernel_time():
    q = torch.empty(2, 20, 1500, 64, dtype=torch.bfloat16)
    rec = {"b": 2, "hq": 20, "tq": 1500, "d": 64, "hk": 20, "tk": 1500,
           "causal": False, "elt": 2}
    c = ctx(trace=trace(), calls={"flash_fwd": [rec, rec]}, peaks=PEAKS)
    least = 2 * 4 * 2 * 20 * 64 * 1500 ** 2 / 989e12
    assert metric_reader("flash_fwd_roofline.rate").read(c) == \
        pytest.approx(100 * least / 0.002)
    del q
    # launches that the calls do not account for: no reading
    c.calls = {"flash_fwd": [rec]}
    assert metric_reader("flash_fwd_roofline.rate").read(c) is None
    # no trace: no reading
    c.trace = None
    assert metric_reader("flash_fwd_roofline.rate").read(c) is None


def test_rate_and_step_readers():
    done = [{"audio_s": 30.0, "tokens": [1] * 100}] * 40
    c = ctx(window_s=10.0, trace=trace(),
            work={"steps": 50, "admitted": [40], "completed": done},
            traced_work={"completed": done[:10]})
    assert metric_reader("transcribe_audio_s_per_s").read(c) == 120.0
    assert metric_reader("engine_step_ms.rate").read(c) == 200.0
    assert metric_reader("launches_per_token.rate").read(c) == \
        pytest.approx(3 / 1000)
    assert metric_reader("mfu_pct.rate").read(c) > 0


def test_train_readers():
    c = ctx(window_s=2.0, work={"train_label_lens": [104] * 10, "batch": 16},
            memory_peak_bytes=3 * 2 ** 30, cfg=json.loads(
                (ROOT / "benchmark/configs/whisper-small.json").read_text()))
    assert metric_reader("finetune_examples_per_s").read(c) == 80.0
    assert metric_reader("peak_mem_gib.train").read(c) == 3.0
    from benchmark.lib import flops
    want = 100 * 10 * flops.train_step(c.cfg, 16, 104) / (2.0 * 989e12)
    assert metric_reader("mfu_pct.train").read(c) == pytest.approx(want)


def test_every_metric_has_a_reader():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert hasattr(metric_reader(m["name"]), "read")


@pytest.mark.parametrize("cell", ["turbo-speech-backlog",
                                  "small-finetune-bf16"])
def test_traced_run_reads_each_half(cell):
    import tiny
    res = tiny.run(cell, seconds=6.0, trace=True)
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bm["per_layer"]
             if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) <= names
    assert any(k.startswith("mfu_pct") for k in res["metrics"])
    assert any(k.startswith("device_idle_pct") for k in res["metrics"])
    # the traced half lasts its half of the window (or to the end of the
    # step running when that half is over)
    assert res["device"]["window_s"] >= 3.0
