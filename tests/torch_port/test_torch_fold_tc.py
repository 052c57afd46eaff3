"""P1, K2's head folds, on the tensor-core bodies (``csrc/flash_fwd_sm90.cu``
in bf16, ``csrc/flash_fwd_tf32x3.cu`` in float32), on the CPU, where
nothing can launch.

* Routing: every fold of ``FOLDS`` resolves to the tensor-core body of its
  dtype in ``FWD_BODIES``, and ``fold_fwd_cuda``, ``launch_flash_forward``
  and ``flash_forward`` hand a folded call on (stand-in) CUDA tensors to
  that body's launcher alone, with the fold; the launcher passes it to the
  C entry point in the prototype's place.
* The sources: each instantiation macro lists exactly the table's folded
  entries, each fits one block's shared memory by the source's own
  ``smem_bytes`` (read through ``csrc_constexpr.py``), which the Python
  formulas ``resolve_tile`` checks equal; a fold no formula fits raises,
  naming its body and the limit.
* The float32 fold transcribed into numpy (``tf32x3_lanes.fwd_warps``, the
  3xTF32 products lane by lane): the grid's block -> heads -> warp group ->
  warp mapping, blocks whose heads cross a batch boundary of the fused B*H
  axis, a ragged key count (1500 of 1536 scaled down to 188 of 192) and
  fold 4's ring of 32-key half tiles; it equals ``fold_fwd_plain`` within
  1e-5 and the JAX tool's ``fold_fwd`` (its Pallas kernel in interpret
  mode) within 1e-4, o and lse.
"""

import functools
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audax_torch.ops import attention as att
from audax_torch.tools import attn_headfold_probe as hf

from .csrc_constexpr import CSRC, constexpr_function
from .tf32x3_lanes import G, T, fwd_warps

REPO = Path(__file__).resolve().parents[2]
SMEM_LIMIT = 232448
LOG2E = np.float32(1.4426950408889634)
BODY = {torch.float32: "tf32x3", torch.bfloat16: "wgmma"}
#: each tensor-core body's source, instantiation macro and C entry point
SOURCES = {"wgmma": ("flash_fwd_sm90.cu", "AUDAX_FWD90", "flash_fwd_sm90"),
           "tf32x3": ("flash_fwd_tf32x3.cu", "AUDAX_TF32X3",
                      "flash_fwd_tf32x3")}


@pytest.fixture(scope="module")
def jax_headfold():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_attn_headfold_probe_tc", REPO / "tools" /
        "attn_headfold_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counters(monkeypatch):
    """The launch counters these tests move on stand-in calls, put back as
    they were afterwards (other tests read them as totals)."""
    for fn in (hf.fold_fwd_cuda, att.flash_forward_cuda,
               att.flash_forward_wgmma_cuda, att.flash_forward_tf32x3_cuda):
        monkeypatch.setattr(fn, "launches", fn.launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# ---- routing ------------------------------------------------------------------

@pytest.mark.parametrize("fold", att.FOLDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_every_fold_routes_to_the_tensor_core_body_of_its_dtype(dtype, fold):
    assert att.fwd_body(dtype, 64, fold=fold) == BODY[dtype]
    assert att.fwd_body(dtype, 64, 64, 64, fold) == BODY[dtype]
    assert att.resolve_tile("fwd", 64, fold=fold, dtype=dtype) == (64, 64)
    assert "cuda_core" not in {b for (_, _, _, f), b in
                               att.FWD_BODIES.items() if f > 1}


class _OnCard:
    """A stand-in CUDA tensor: enough of one for the wrappers' checks
    before they hand a call to a launcher."""

    is_cuda = True
    device = "cuda:0"

    def __init__(self, *shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def __getitem__(self, idx):
        assert idx is None
        return _OnCard(1, *self.shape, dtype=self.dtype)


def _record_launchers(monkeypatch):
    """Replace both tensor-core launchers; each call is recorded as (body,
    fold, block_q, block_k) and answers zeros of the output's shape."""
    calls = []
    for body, attr in (("wgmma", "flash_forward_wgmma_cuda"),
                       ("tf32x3", "flash_forward_tf32x3_cuda")):
        def launcher(q, k, v, *, body=body, fold=1, block_q=None,
                     block_k=None, **kw):
            calls.append((body, fold, block_q, block_k))
            b, hq, tq, d = q.shape
            return torch.zeros(b, hq, tq, d), torch.zeros(b * hq, tq)
        monkeypatch.setattr(att, attr, launcher)
    return calls


@pytest.mark.parametrize("fold", att.FOLDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_folded_calls_reach_the_one_launcher_the_table_names(monkeypatch,
                                                             counters,
                                                             dtype, fold):
    calls = _record_launchers(monkeypatch)
    want = [(BODY[dtype], fold, 64, 64)]
    q3 = _OnCard(8, 192, 64, dtype=dtype)
    before = hf.fold_fwd_cuda.launches
    o, lse = hf.fold_fwd_cuda(q3, q3, q3, scale=0.125, kv_len=188, fold=fold)
    assert calls == want and hf.fold_fwd_cuda.launches == before + 1
    assert o.shape == (8, 192, 64) and lse.shape == (8, 192, 1)
    q = _OnCard(2, 4, 192, 64, dtype=dtype)
    calls.clear()
    att.launch_flash_forward(q, q, q, fold=fold, kv_len=100)
    assert calls == want
    # the product entry counts no CUDA-core launch for a fold
    calls.clear()
    core = att.flash_forward_cuda.launches
    att.flash_forward(q, q, q, fold=fold)
    assert calls == want and att.flash_forward_cuda.launches == core


def test_a_fold_that_does_not_divide_the_heads_reaches_no_launcher(
        monkeypatch):
    calls = _record_launchers(monkeypatch)
    q = _OnCard(1, 3, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divisible"):
        att.launch_flash_forward(q, q, q, fold=2)
    assert calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_the_launcher_passes_the_fold_in_the_prototypes_place(monkeypatch,
                                                               counters,
                                                               dtype):
    """The tensor-core launcher's C call, read against the parameter names
    of the source's prototype: the fold lands where the entry point reads
    it."""
    source, _, entry = SOURCES[BODY[dtype]]
    params = [p.split()[-1].lstrip("*") for p in re.search(
        rf"int {entry}\(([^)]*)\)", (CSRC / source).read_text())[1].split(",")]
    got = {}

    def c_entry(*args):
        got.update(zip(params, args))
        return 0
    monkeypatch.setattr(att, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(att.native, "library",
                        lambda name: SimpleNamespace(**{name: c_entry}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=7))
    q = torch.zeros(2, 3, 40, 64, dtype=dtype)
    launcher = {"wgmma": att.flash_forward_wgmma_cuda,
                "tf32x3": att.flash_forward_tf32x3_cuda}[BODY[dtype]]
    before = launcher.launches
    launcher(q, q, q, block_q=64, block_k=64, fold=2, kv_len=37)
    assert launcher.launches == before + 1
    assert len(got) == len(params)
    assert {k: got[k] for k in ("batch", "hq", "hkv", "tq", "kv_len",
                                "tk_stride", "head_dim", "block_q",
                                "block_k", "fold", "stream")} == dict(
        batch=2, hq=3, hkv=3, tq=40, kv_len=37, tk_stride=40, head_dim=64,
        block_q=64, block_k=64, fold=2, stream=7)


# ---- the sources ----------------------------------------------------------------

def _built(body):
    source, macro, _ = SOURCES[body]
    return {tuple(map(int, m)) for m in re.findall(
        rf"{macro}\((\d+), (\d+), (\d+), (\d+)\)", (CSRC / source).read_text())}


@pytest.mark.parametrize("body", sorted(SOURCES))
def test_macros_list_the_tables_folds_and_each_fits_shared_memory(body):
    folded = {(d,) + tile + (fold,) for (_, d, tile, fold), b in
              att.FWD_BODIES.items() if b == body and fold > 1}
    assert {t for t in _built(body) if t[3] > 1} == folded
    assert folded == {(64, 64, 64, f) for f in att.FOLDS}
    smem = constexpr_function(SOURCES[body][0], "smem_bytes")
    for d, bq, bk, fold in _built(body):
        args = (d, bq, bk, fold) if body == "wgmma" else (d, bk, fold)
        assert smem(*args) <= SMEM_LIMIT
    # each fold's shared memory, by the source's own formula
    if body == "wgmma":
        assert [smem(64, 64, 64, f) for f in (1, 2, 4)] == [
            41984, 82944, 164864]
    else:
        ring = constexpr_function(SOURCES[body][0], "ring_keys")
        assert [ring(64, 64, f) for f in (1, 2, 4)] == [64, 64, 32]
        assert [smem(64, 64, f) for f in (1, 2, 4)] == [69632, 139264,
                                                        139264]


@pytest.mark.parametrize("body", sorted(SOURCES))
def test_resolve_tile_reads_the_formula_of_the_body_that_serves_the_fold(
        body):
    smem = constexpr_function(SOURCES[body][0], "smem_bytes")
    for d in (16, 32, 64, 128):
        for bq, bk in att.TILES:
            for fold in (1,) + att.FOLDS:
                args = (d, bq, bk, fold) if body == "wgmma" else (d, bk, fold)
                assert att._FWD_SMEM[body](d, bq, bk, fold) == smem(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_a_fold_off_shared_memory_raises_naming_the_body(dtype):
    body = BODY[dtype]
    assert att._FWD_SMEM[body](64, 128, 128, 4) > SMEM_LIMIT
    with pytest.raises(ValueError, match=rf"on the {body} body; one block "
                                         rf"may use {SMEM_LIMIT} B"):
        att.resolve_tile("fwd", 64, 128, 128, 4, dtype=dtype)
    q = torch.zeros(8, 64, 64, dtype=dtype)
    with pytest.raises(ValueError, match=body):
        hf.fold_fwd(q, q, q, scale=0.125, kv_len=64, fold=4, block_q=128,
                    block_k=128)


# ---- the float32 fold in numpy -------------------------------------------------

RING_KEYS = constexpr_function("flash_fwd_tf32x3.cu", "ring_keys")
BQ, WARPS = 64, 4


def fold_schedule(q, k, v, *, fold, kv_len, passes=3):
    """``flash_fwd_tf32x3_kernel<64, ring_keys(64, 64, fold), fold>`` in
    numpy, every warp of the grid at once: q [B, Hq, Tq, D], k/v [B, Hkv,
    Tk, D] float32 -> (o, lse [B*Hq, Tq]). Block (x, y) holds heads y *
    fold .. y * fold + fold - 1 of the fused B*Hq axis, warp group g the
    head y * fold + g, its warp w the rows x * 64 + 16 w .. + 15."""
    b, hq, tq, d = q.shape
    group, tk = hq // k.shape[1], k.shape[2]
    bk = RING_KEYS(d, 64, fold)
    nx, ny = -(-tq // BQ), b * hq // fold
    bh = np.arange(ny)[:, None] * fold + np.arange(fold)[None, :]  # [y, g]
    bi, h = np.divmod(bh, hq)
    # Q as each warp reads it (rows past Tq read as 0), scaled for exp2
    qp = np.zeros((b, hq, nx * BQ, d), np.float32)
    qp[:, :, :tq] = q * (np.float32(d ** -0.5) * LOG2E)
    rows = (BQ * np.arange(nx)[:, None, None]
            + 16 * np.arange(WARPS)[None, :, None] + G)      # [x, w, lane]
    qh = qp[bi, h]                                           # [y, g, T, D]
    # A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
    qa = np.stack([np.stack([
        qh[:, :, rows + r8, 8 * kk + tt]                     # [y, g, x, w, 32]
        for r8, tt in ((0, T), (8, T), (0, T + 4), (8, T + 4))], -1)
        for kk in range(d // 8)], -3)                   # [y, g, x, w, KS, 32, 4]
    # each head's ring: its kv head's rows, zero past kv_len
    ring = -(-kv_len // bk) * bk
    kst, vst = (np.zeros((ny, fold, 1, 1, ring, d), np.float32)
                for _ in range(2))
    kv = (bh // hq) * (hq // group) + (bh % hq) // group
    kb, kh = np.divmod(kv, hq // group)
    kst[:, :, 0, 0, :kv_len] = k[kb, kh, :kv_len]
    vst[:, :, 0, 0, :kv_len] = v[kb, kh, :kv_len]
    ow, lw = fwd_warps(qa, kst, vst, kv_len, bk, passes)  # [y, g, x, w, 16]
    o = np.zeros((b, hq, nx * BQ, d), np.float32)
    lse = np.zeros((b * hq, nx * BQ), np.float32)
    r16 = (BQ * np.arange(nx)[:, None, None]
           + 16 * np.arange(WARPS)[None, :, None] + np.arange(16))
    for y in range(ny):
        for g in range(fold):
            o[bi[y, g], h[y, g], r16] = ow[y, g]
            lse[bh[y, g], r16] = lw[y, g]
    return o[:, :, :tq], lse[:, :tq]


def _grid_inputs(seed, b, hq, t):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, hq, t, 64)).astype(np.float32)
                 for _ in range(3))


#: (B, Hq, T, kv_len, fold): the probe's own form (B 1), blocks whose heads
#: cross a batch boundary (B 2, H 3 at fold 2: block 1 holds (0, 2) and
#: (1, 0); H 6 at fold 4: block 1 holds (0, 4) .. (1, 1)), and the ragged
#: key count of the card's case (1500 of 1536) cut to 188 of 192
GRID_CASES = {
    "probe_fold2_ragged": (1, 8, 192, 188, 2),
    "probe_fold4_ragged": (1, 8, 192, 188, 4),
    "batch_boundary_fold2": (2, 3, 128, 125, 2),
    "batch_boundary_fold4_ragged": (2, 6, 192, 188, 4),
    "batch_boundary_fold4_full": (2, 6, 128, 128, 4),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_fold_schedule_equals_the_plain_version_and_jax(jax_headfold,
                                                        interpret, case):
    b, hq, t, kv_len, fold = GRID_CASES[case]
    q, k, v = _grid_inputs(len(case) + fold, b, hq, t)
    o, lse = fold_schedule(q, k, v, fold=fold, kv_len=kv_len)
    q3, k3, v3 = (a.reshape(b * hq, t, 64) for a in (q, k, v))
    ref_o, ref_lse = hf.fold_fwd_plain(*(torch.from_numpy(a) for a in
                                         (q3, k3, v3)),
                                       scale=0.125, kv_len=kv_len)
    o3 = o.reshape(b * hq, t, 64)
    assert float(np.abs(o3 - ref_o.numpy()).max()) <= 1e-5
    assert float(np.abs(lse - ref_lse.numpy()[..., 0]).max()) <= 1e-5
    jo, jl = jax_headfold.fold_fwd(
        *(jnp.asarray(a) for a in (q3, k3, v3)), scale=0.125,
        kv_len=kv_len, block_q=64, block_k=64, fold=fold)
    np.testing.assert_allclose(o3, np.asarray(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lse, np.asarray(jl)[..., 0], rtol=0,
                               atol=1e-4)


def test_fold4_ring_holds_half_tiles_where_whole_ones_do_not_fit():
    """Fold 4 stages 32-key halves: rings of whole 64-key tiles would take
    278,528 B; its softmax steps by the half and still matches the plain
    version, while the same grid at fold 2 steps by whole tiles."""
    smem = constexpr_function("flash_fwd_tf32x3.cu", "smem_bytes")
    assert 4 * 16 * 64 * 68 == 278528 > SMEM_LIMIT
    assert RING_KEYS(64, 64, 4) == 32 and RING_KEYS(64, 64, 2) == 64
    assert smem(64, 64, 4) == 4 * 16 * 32 * 68
    q, k, v = _grid_inputs(5, 1, 4, 64)
    ref = att.flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    for fold in att.FOLDS:
        o, lse = fold_schedule(q, k, v, fold=fold, kv_len=64)
        assert float(np.abs(o - ref[0].numpy()).max()) <= 1e-5
        assert float(np.abs(lse - ref[1].numpy()).max()) <= 1e-5


def test_one_tf32_pass_breaks_the_fold_parity():
    """The fold keeps 3xTF32's parity: one TF32 pass in the same schedule
    is at least 10x worse (fixed seed)."""
    q, k, v = _grid_inputs(11, 1, 4, 128)
    ref = att.flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    errs = [float(np.abs(fold_schedule(q, k, v, fold=2, kv_len=128,
                                       passes=p)[0] - ref[0].numpy()).max())
            for p in (3, 1)]
    assert errs[0] <= 1e-5 and errs[1] >= 10 * errs[0] and errs[1] > 1e-4
