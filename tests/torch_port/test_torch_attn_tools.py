"""The attention tooling of the port vs the JAX package, on the CPU.

* P1: ``tools/attn_headfold_probe.py:fold_fwd_plain`` (K2's plain math on
  the first ``kv_len`` keys of each head) against the JAX tool's
  ``fold_fwd``, its Pallas kernel in interpret mode (the ``interpret``
  fixture wraps ``pallas_call``; the JAX tool is imported by path). BH 8,
  T 32 and 64, D 16 and 64, fold 2 and 4, ``kv_len`` equal to and below the
  padded key rows. O and lse within 1e-5 of their largest JAX value in
  float32 (another summation order); within 1e-2 in bfloat16 (the plain
  version rounds the scores to bfloat16 before the softmax, the kernel
  keeps them in float32).
* ``flash_attention(fold=)`` follows JAX's ``_pick_fold``; the tiles and
  folds a wrapper takes are the documented set, and anything else raises
  ``ValueError`` before any dispatch.
* K2's body table (``FWD_BODIES``): every call the paths and tools make
  resolves to one body -- bf16 at 64 or more query rows to the tensor
  cores (wgmma), float32 at 64 query rows to the tensor cores too
  (3xTF32), the folds included, the rest to the CUDA cores -- the table
  agrees with the instantiations in the sources, and every tile fits one
  block's shared memory (the tensor-core body's ``smem_bytes`` read from
  its source).
* ``dot_product_attention(backend=)`` and ``attention_backend`` route to
  the twin or the flash path (read off the plain versions' counters).
* ``utils/flops.py`` equals the JAX package's exactly.
* The four tools run end to end on the CPU, their rows carry the JAX
  tools' keys (``peak_mem_gb``, ``torch_counted_tflops`` and
  ``first_step_s`` replace ``planned_peak_hbm_gb``, ``xla_counted_tflops``
  and ``compile_s``), ``--out`` writes JSON and nothing lands in
  ``results/``.
* ``resolve_device`` sets float32 accumulation for bf16/fp16 matmuls.
"""

import functools
import importlib.util
import json
import re
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audax.core.config import WhisperConfig as JWhisperConfig
from audax.utils import flops as JF
from audax_torch.core import runtime
from audax_torch.core.config import WhisperConfig
from audax_torch.ops import attention as att
from audax_torch.tools import attn_block_probe as bp
from audax_torch.tools import attn_headfold_probe as hf
from audax_torch.tools import cli, mfu_study, probe_launch_counts
from audax_torch.tools import train_step_breakdown as tsb
from audax_torch.utils import flops as TF

from .csrc_constexpr import constexpr_function

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def jax_headfold():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_attn_headfold_probe", REPO / "tools" /
        "attn_headfold_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---- P1 against the JAX tool's Pallas kernel --------------------------------

#: (Tq, padded Tk, kv_len, block_q, block_k) of the JAX grid
FOLD_CASES = [(32, 32, 32, 16, 16), (64, 64, 50, 32, 32)]


@pytest.mark.parametrize("tq,tk_p,kv_len,block_q,block_k", FOLD_CASES,
                         ids=["kv_len=Tk_p", "kv_len<Tk_p"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("fold", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fold_plain_matches_pallas(jax_headfold, interpret, tq, tk_p, kv_len,
                                   block_q, block_k, d, fold, dtype):
    bh = 8
    q, k, v = (torch.from_numpy(_normal(s, (bh, t, d))).to(dtype)
               for s, t in ((1, tq), (2, tk_p), (3, tk_p)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v))
    scale = d ** -0.5
    ref_o, ref_lse = jax_headfold.fold_fwd(
        jq, jk, jv, scale=scale, kv_len=kv_len, block_q=block_q,
        block_k=block_k, fold=fold)
    before = hf.fold_fwd_plain.launches
    o, lse = hf.fold_fwd_plain(q, k, v, scale=scale, kv_len=kv_len)
    assert hf.fold_fwd_plain.launches == before + 1
    assert o.dtype == dtype and lse.shape == (bh, tq, 1)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in ((o, ref_o), (lse, ref_lse)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=rel * np.abs(ref).max())


def test_fold_fwd_checks_the_set_and_refuses_cpu_tensors():
    q = torch.zeros(8, 32, 64)
    with pytest.raises(ValueError, match="CUDA"):
        hf.fold_fwd_cuda(q, q, q, scale=0.125, kv_len=32, fold=2)
    before = hf.fold_fwd_plain.launches
    for kw in (dict(fold=3), dict(fold=2, block_q=32),
               dict(fold=4, block_q=128, block_k=128)):
        with pytest.raises(ValueError):
            hf.fold_fwd(q, q, q, scale=0.125, kv_len=32, **kw)
    assert hf.fold_fwd_plain.launches == before
    o, _ = hf.fold_fwd(q, q, q, scale=0.125, kv_len=32, fold=4)
    assert hf.fold_fwd_plain.launches == before + 1 and o.shape == q.shape


# ---- fold and tiles in the product call ---------------------------------------

def _qkv(b=2, h=4, t=40, d=64, hkv=None, seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((b, hq, t, d)).astype(
        np.float32)) for hq in (h, hkv or h, hkv or h))


def test_flash_attention_fold_on_cpu_equals_fold_1():
    q, k, v = _qkv()
    torch.testing.assert_close(att.flash_attention(q, k, v, fold=2),
                               att.flash_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("kw,bhq,want", [
    (dict(causal=False, group=1), 8, 2),
    (dict(causal=True, group=1), 8, 1),       # causal keeps fold 1
    (dict(causal=False, group=2), 8, 1),      # GQA keeps fold 1
    (dict(causal=False, group=1), 7, 1),      # B*Hq not divisible
])
def test_pick_fold_follows_jax(kw, bhq, want):
    assert att.pick_fold(2, bhq=bhq, **kw) == want
    assert att.pick_fold(4, bhq=bhq, **kw) == want      # capped at 2
    assert att.pick_fold(1, bhq=bhq, **kw) == 1


def test_flash_attention_fold_falls_back_where_jax_does():
    """Causal, GQA and odd B*Hq run unfolded, so even a fold the kernel
    is not built for there is accepted."""
    q, k, v = _qkv(d=32)                       # fold is built at D = 64 only
    att.flash_attention(q, k, v, causal=True, fold=2)
    q, k, v = _qkv(h=4, hkv=2)
    att.flash_attention(q, k, v, fold=2)
    q, k, v = _qkv(b=1, h=3)
    att.flash_attention(q, k, v, fold=2)
    with pytest.raises(ValueError, match="fold 2"):
        att.flash_attention(*_qkv(d=32), fold=2)


@pytest.mark.parametrize("tile", att.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_documented_tile_runs_on_cpu(tile):
    q, k, v = _qkv(seed=1)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = att.flash_attention(*qs, block_q=tile[0], block_k=tile[1])
    out_ref = att.flash_attention(*ref)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    out.sum().backward()
    out_ref.sum().backward()
    for a, b in zip(qs, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    assert att.resolve_tile("dkv", 64, *tile) == tile


@pytest.mark.parametrize("call,match", [
    (lambda q, k, v: att.flash_attention(q, k, v, block_q=16), "tile"),
    (lambda q, k, v: att.flash_attention(q, k, v, block_k=256), "tile"),
    (lambda q, k, v: att.flash_forward(q, k, v, fold=3), "fold 3"),
    (lambda q, k, v: att.flash_forward(q, k, v, fold=2, block_q=32),
     "tile \\(64, 64\\)"),
    (lambda q, k, v: att.flash_forward(q, k, v, fold=4, block_q=128,
                                       block_k=128), "shared memory"),
    (lambda q, k, v: att.flash_backward(q, k, v, q, torch.zeros(8, 40), q,
                                        block_q=64, block_k=16), "tile"),
])
def test_unsupported_tiles_raise_before_dispatch(call, match):
    q, k, v = _qkv()
    before = {n: f.launches for n, f in (
        ("fwd", att.flash_forward_plain), ("dq", att.flash_backward_dq_plain),
        ("dkv", att.flash_backward_dkv_plain))}
    with pytest.raises(ValueError, match=match):
        call(q, k, v)
    assert before == {"fwd": att.flash_forward_plain.launches,
                      "dq": att.flash_backward_dq_plain.launches,
                      "dkv": att.flash_backward_dkv_plain.launches}


def test_tiles_off_head_dim_64_keep_the_defaults_only():
    assert att.resolve_tile("fwd", 32) == (64, 64)
    assert att.resolve_tile("dkv", 128) == (64, 64)
    assert att.resolve_tile("dkv", 128, 64, 64) == (64, 64)
    with pytest.raises(ValueError):
        att.resolve_tile("dkv", 128, 64, 32)
    with pytest.raises(ValueError):
        att.resolve_tile("fwd", 32, 32, 32)
    with pytest.raises(ValueError):
        att.resolve_tile("dq", 128, 64, 32)


# ---- K2's body table --------------------------------------------------------------

def _k2_calls():
    """Every (dtype, head_dim, block_q, block_k, fold) of a K2 call the
    paths and tools make: each path's default at every head dim, the block
    probe's grid, the fold probe's arms and ``flash_attention(fold=)``."""
    calls = set()
    for dt in (torch.float32, torch.bfloat16):
        calls |= {(dt, d, None, None, 1) for d in (16, 32, 64, 128)}
        calls |= {(dt, 64, bq, bk, 1) for bq, bk in bp.GRID}
        calls |= {(dt, 64, bq, hf.BLOCK_K, f) for _, f, bq in hf.ARMS}
        calls |= {(dt, 64, None, None, f) for f in att.FOLDS}
    return sorted(calls, key=str)


@pytest.mark.parametrize("call", _k2_calls(), ids=str)
def test_every_k2_call_resolves_to_one_body(call):
    dt, d, bq, bk, fold = call
    body = att.fwd_body(dt, d, bq, bk, fold)
    tile = att.resolve_tile("fwd", d, bq, bk, fold, dtype=dt)
    assert body in ("cuda_core", "tf32x3", "wgmma")
    assert att.FWD_BODIES[(dt, d, tile, fold)] == body
    wgmma = dt == torch.bfloat16 and tile[0] >= 64
    tf32x3 = dt == torch.float32 and tile[0] == 64
    assert body == ("wgmma" if wgmma else "tf32x3" if tf32x3
                    else "cuda_core")


def test_head_dims_no_kernel_takes_keep_the_plain_path_on_cpu():
    """A head dim off the kernels' set (8, a tiny test model's) resolves to
    the default tile and runs the plain version on the CPU, in either
    dtype, as before the body table; it has no body on the card."""
    for dt in (torch.float32, torch.bfloat16):
        assert att.resolve_tile("fwd", 8, dtype=dt) == att._default_tile(
            "fwd", 8, dt)
        with pytest.raises(ValueError, match="no body"):
            att.fwd_body(dt, 8)
        q, k, v = (t.to(dt) for t in _qkv(d=8))
        out = att.flash_attention(q, k, v)
        torch.testing.assert_close(out, att.xla_attention(q, k, v),
                                   rtol=0, atol=0)


def test_bf16_keeps_32_row_tiles_on_the_cuda_cores_and_folds_on_wgmma():
    bf16 = torch.bfloat16
    for bk in (32, 64, 128):
        assert att.fwd_body(bf16, 64, 32, bk) == "cuda_core"
    for fold in att.FOLDS:
        assert att.fwd_body(bf16, 64, fold=fold) == "wgmma"
        assert att.fwd_body(torch.float32, 64, fold=fold) == "tf32x3"
        assert att.resolve_tile("fwd", 64, fold=fold, dtype=bf16) == (64, 64)
    for d in (16, 32, 64, 128):
        assert att.resolve_tile("fwd", d, dtype=bf16) == att.WGMMA_TILE
        assert att.fwd_body(bf16, d) == "wgmma"
        assert att.fwd_body(torch.float32, d) == "tf32x3"


@pytest.mark.parametrize("call", [
    (torch.bfloat16, 32, 64, 64, 1), (torch.bfloat16, 128, 32, 32, 1),
    (torch.bfloat16, 16, 128, 64, 1), (torch.bfloat16, 64, 256, 64, 1),
    (torch.bfloat16, 64, 128, 128, 2), (torch.float32, 32, 128, 64, 1),
], ids=str)
def test_k2_calls_off_the_body_table_raise(call):
    dt, d, bq, bk, fold = call
    with pytest.raises(ValueError):
        att.fwd_body(dt, d, bq, bk, fold)
    q = torch.zeros(1, 2, 20, d, dtype=dt)
    before = att.flash_forward_plain.launches
    with pytest.raises(ValueError):
        att.flash_forward(q, q, q, block_q=bq, block_k=bk, fold=fold)
    assert att.flash_forward_plain.launches == before


def test_body_table_matches_the_sources_and_fits_shared_memory():
    csrc = REPO / "audax_torch" / "csrc"
    wgmma = {tuple(map(int, m)) for m in re.findall(
        r"AUDAX_FWD90\((\d+), (\d+), (\d+), (\d+)\)",
        (csrc / "flash_fwd_sm90.cu").read_text())}
    core = {tuple(map(int, m)) for m in re.findall(
        r"AUDAX_FWD\((\d+), (\d+), (\d+), (\d+)\)",
        (csrc / "flash_fwd.cu").read_text())}
    table = {body: {(d,) + tile + (fold,)
                    for (_, d, tile, fold), b in att.FWD_BODIES.items()
                    if b == body} for body in ("cuda_core", "wgmma")}
    assert table["wgmma"] == wgmma
    assert table["cuda_core"] <= core
    # the CUDA-core body is built, in either dtype, wherever float32 runs,
    # the folds included (their A/B against the tensor-core bodies)
    assert {(d,) + tile + (fold,) for (dt, d, tile, fold) in att.FWD_BODIES
            if dt == torch.float32} <= core
    # the head-fold probe's bf16 arms all run on the wgmma body
    assert all(att.FWD_BODIES[(torch.bfloat16, 64, (bq, hf.BLOCK_K), f)]
               == "wgmma" for _, f, bq in hf.ARMS)
    smem = constexpr_function("flash_fwd_sm90.cu", "smem_bytes")
    assert all(smem(*t) <= 232448 for t in wgmma)
    assert all(att._fwd_smem(*t) <= 232448 for t in core)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_forward_wgmma_cuda(*[torch.zeros(1, 2, 20, 64)] * 3)


# ---- the backend and its scoped default ----------------------------------------

def _flash_calls(fn):
    before = att.flash_forward_plain.launches
    fn()
    return att.flash_forward_plain.launches - before


def test_backend_argument_and_scope_reach_the_twin():
    q, k, v = _qkv()
    ref = att.xla_attention(q, k, v)
    assert _flash_calls(lambda: att.dot_product_attention(q, k, v)) == 1
    got = []
    assert _flash_calls(lambda: got.append(att.dot_product_attention(
        q, k, v, backend="xla"))) == 0
    torch.testing.assert_close(got[0], ref, rtol=0, atol=0)
    with att.attention_backend("xla"):
        assert _flash_calls(lambda: att.dot_product_attention(q, k, v)) == 0
        with att.attention_backend("flash"):
            assert _flash_calls(
                lambda: att.dot_product_attention(q, k, v)) == 1
        assert _flash_calls(lambda: att.dot_product_attention(q, k, v)) == 0
        assert _flash_calls(lambda: att.dot_product_attention(
            q, k, v, backend="flash")) == 1
    assert _flash_calls(lambda: att.dot_product_attention(q, k, v)) == 1
    with pytest.raises(ValueError):
        att.dot_product_attention(q, k, v, backend="pallas")
    assert att._backend_default == "flash"
    with pytest.raises(ValueError):
        with att.attention_backend("cudnn"):
            pass


def test_backend_scope_reaches_other_threads_and_remat():
    """On the card the autograd engine runs the backward -- and with it the
    recomputation of a checkpointed layer -- on a thread of its own: the
    scope must hold there, or the recomputed layer takes the other path
    and saves other tensors than its forward did."""
    q, k, v = _qkv()
    seen = []
    with att.attention_backend("xla"):
        t = threading.Thread(target=lambda: seen.append(_flash_calls(
            lambda: att.dot_product_attention(q, k, v))))
        t.start()
        t.join(timeout=60)
        qg = q.clone().requires_grad_(True)
        out = torch.utils.checkpoint.checkpoint(
            lambda x: att.dot_product_attention(x, k, v), qg,
            use_reentrant=False)
        assert _flash_calls(lambda: out.sum().backward()) == 0
    assert not t.is_alive() and seen == [0]
    qx = q.clone().requires_grad_(True)
    att.xla_attention(qx, k, v).sum().backward()
    torch.testing.assert_close(qg.grad, qx.grad, rtol=0, atol=0)


# ---- analytic FLOPs -------------------------------------------------------------

@pytest.mark.parametrize("size", ["tiny", "base", "small", "medium"])
def test_flops_equal_jax(size):
    cfg, jcfg = getattr(WhisperConfig, size)(), getattr(JWhisperConfig, size)()
    for batch in (1, 8, 32):
        assert TF.whisper_encoder_fwd_flops(cfg, batch) == \
            JF.whisper_encoder_fwd_flops(jcfg, batch)
        for label_len in (8, 40, 448):
            assert TF.whisper_decoder_fwd_flops(cfg, batch, label_len) == \
                JF.whisper_decoder_fwd_flops(jcfg, batch, label_len)
            for remat in ("none", "full", "dots", True, False):
                for lora in (False, True):
                    assert TF.whisper_train_step_flops(
                        cfg, batch, label_len, remat=remat, lora=lora) == \
                        JF.whisper_train_step_flops(
                            jcfg, batch, label_len, remat=remat, lora=lora)


# ---- the four tools end to end on the CPU ------------------------------------------

@pytest.fixture
def results_untouched():
    before = sorted(p.relative_to(REPO) for p in (REPO / "results").rglob("*"))
    yield
    assert before == sorted(p.relative_to(REPO)
                            for p in (REPO / "results").rglob("*"))


def _keys(rows):
    return set().union(*(r.keys() for r in rows))


def test_headfold_probe_on_cpu(tmp_path, results_untouched):
    path = tmp_path / "fold.json"
    rep = cli(hf.main, ["--device", "cpu", "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    arms = [r["arm"] for r in rep["rows"]]
    assert arms == [a for a, _, _ in hf.ARMS] + ["product_fold2",
                                                 "product_fold1"]
    assert {"us", "tflops", "max_abs_err_vs_base",
            "speedup_vs_default"} <= _keys(rep["rows"][:4])
    assert all(r["max_abs_err_vs_base"] == 0 for r in rep["rows"][:4])
    assert {"best_speedup", "product_speedup_fold2"} <= set(rep)
    assert rep["verdict"] in ("keep", "reject")
    counts = probe_launch_counts()["flash_forward_fold"]
    assert counts["cuda"] == 0 and counts["plain"] > 0


def test_block_probe_on_cpu(tmp_path, results_untouched):
    path = tmp_path / "blocks.json"
    rep = cli(bp.main, ["--device", "cpu", "--out", str(path)])
    assert json.loads(path.read_text())["rows"] == json.loads(
        json.dumps(rep["rows"]))
    tiles = [(r["block_q"], r["block_k"]) for r in rep["rows"]]
    assert tiles[0] == (None, None)
    assert sorted(tiles[1:]) == sorted(att.TILES)
    assert tuple(rep["best_fwd"].values()) in att.TILES
    assert {"block_q", "block_k", "fwd_us", "fwd_tflops", "bwd_us",
            "bwd_tflops"} <= _keys(rep["rows"])
    assert not any("error" in r for r in rep["rows"])
    assert all(r["max_abs_err_vs_default"] == 0 for r in rep["rows"])
    assert rep["verdict"] in ("keep", "reject")


JAX_STAGES = {"encoder_fwd", "encoder_grad", "decoder_fwd", "forward",
              "loss_grad", "matmul_proj_bs_d_d", "matmul_qkv_3sep",
              "matmul_qkv_fused_d_3d", "matmul_mlp_pair",
              "attention_enc_shape", "gelu_exact_4d", "layer_norm_d",
              "optimizer", "full_step_dots"}


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_train_step_breakdown_on_cpu(tmp_path, results_untouched, attn):
    path = tmp_path / "stages.json"
    before = att.flash_forward_plain.launches
    rep = tsb.cli(["--device", "cpu", "--attn", attn, "--iters", "1",
                   "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    stages = {r["stage"]: r for r in rep["rows"]}
    assert set(stages) == JAX_STAGES
    for name, row in stages.items():
        assert set(row) - {"stage"} == ({"us", "tflops"} if name.startswith(
            ("matmul", "attention", "gelu", "layer_norm")) else
            {"ms", "tflops"})
    assert rep["verdict"] == "measured" and rep["attn"] == attn
    ran_flash = att.flash_forward_plain.launches > before
    assert ran_flash == (attn == "flash")


def test_train_step_breakdown_only_and_moments():
    rep = tsb.main(device="cpu", iters=1, only="optimizer", moments="int8")
    assert [r["stage"] for r in rep["rows"]] == ["optimizer_int8"]


JAX_CONFIG_KEYS = {"size", "lora_rank", "batch", "dtype", "remat", "accum",
                   "moments", "sec_per_step", "examples_per_sec",
                   "audio_seconds_per_sec", "achieved_tflops",
                   "mfu_pct_of_peak", "pct_of_session_roofline", "loss"}


def test_mfu_study_on_cpu_resumes_from_out(tmp_path, results_untouched):
    path = tmp_path / "mfu.json"
    rep = mfu_study.cli(["--device", "cpu", "--only", "0", "--steps", "1",
                         "--out", str(path)])
    assert [c["batch"] for c in rep["configs"]] == [8]
    first = rep["configs"][0]
    assert set(first) == JAX_CONFIG_KEYS | {"torch_counted_tflops",
                                            "peak_mem_gb", "first_step_s"}
    assert first["peak_mem_gb"] is None          # no card, no device memory
    assert rep["h100_bf16_peak_tflops"] == 989.0 and rep["roofline_tflops"]
    rep = mfu_study.main(device="cpu", only="0,10", steps=1, out=str(path))
    assert rep["configs"][0] == first            # row 0 not run again
    assert [(c["lora_rank"], c["batch"]) for c in rep["configs"]] == [
        (0, 8), (8, 16)]
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    assert rep["verdict"] == "measured"
    assert len(mfu_study.GRID) == 19 and mfu_study.GRID[10] == (
        "small", 8, 16, "bfloat16", "dots", 1)


@pytest.mark.parametrize("tool", [hf, bp, tsb, mfu_study],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_default_to_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main()


# ---- precision flags (bf16 training accumulates in float32) -------------------------

def test_resolve_device_sets_full_precision_matmuls(monkeypatch):
    m = torch.backends.cuda.matmul
    for flag in ("allow_tf32", "allow_bf16_reduced_precision_reduction",
                 "allow_fp16_reduced_precision_reduction"):
        monkeypatch.setattr(m, flag, True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    runtime.full_precision_matmuls()
    assert not m.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert not m.allow_bf16_reduced_precision_reduction
    assert not m.allow_fp16_reduced_precision_reduction
