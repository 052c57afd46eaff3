"""Port of the int4 kernel-experiment tools vs the JAX tools in ``tools/``.

The JAX tools are imported by path and their Pallas kernels run in
interpret mode: ``int4_layout_ab.int4_matmul_v2`` and
``w4a8_probe.w4a8_matmul`` take ``interpret=True``; ``plane_matmul`` and
``run_variant`` have no such argument, so the ``interpret`` fixture wraps
``jax.experimental.pallas.pallas_call`` for the test's duration. Nothing in
``tools/`` or ``audax/`` changes.

Packings must be bit-identical to JAX's (codes, scales, group). Each plain
version is held against its Pallas kernel on the same numpy inputs: float32
within 1e-5 of max |JAX| (the two sum the same products in another order),
bfloat16 within 1e-2 of it (one bf16 step of the output, where a float32
difference in the sum flips a rounding). W4A8's int8 activations must be
bit-identical. Each tool then runs end to end on the CPU at a small shape.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audax_torch.ops import int4_matmul as T4
from audax_torch.tools import cli, probe_launch_counts, reset_probe_launches
from audax_torch.tools import int4_layout_ab as lab
from audax_torch.tools import int4_plane_probe as pp
from audax_torch.tools import int4_unpack_probe as up
from audax_torch.tools import w4a8_probe as wp

REPO = Path(__file__).resolve().parents[2]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jt():
    return {n: _jax_tool(n) for n in ("int4_layout_ab", "int4_plane_probe",
                                      "w4a8_probe", "int4_unpack_probe")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(seed, m, k_dim, n, dtype):
    """(torch x in ``dtype``, the same values as a jax array, w)."""
    x = _normal(seed, (m, k_dim))
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16 if dtype ==
                     torch.bfloat16 else jnp.float32)
    return xt, xj, _normal(seed + 1, (k_dim, n))


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(
        np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


# ---- packings ---------------------------------------------------------------

@pytest.mark.parametrize("k_dim,group", [(1280, None), (256, None),
                                         (320, 64), (96, 128)])
def test_quantize_int4_v2_bit_identical(jt, k_dim, group):
    w = _normal(3, (k_dim, 160))
    w[5] = 0.0                               # an all-zero row hits the floor
    jw, js = jt["int4_layout_ab"].quantize_int4_v2(jnp.asarray(w),
                                                   group=group)
    word, s = lab.quantize_int4_v2(torch.from_numpy(w), group=group)
    assert word.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(word.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if k_dim == 1280 and group is None:
        assert k_dim // s.shape[0] == 32
    np.testing.assert_array_equal(
        lab.dequantize_int4_v2(word, s).numpy(),
        np.asarray(jt["int4_layout_ab"].dequantize_int4_v2(jw, js)))


@pytest.mark.parametrize("k_dim,group", [(1280, 128), (320, 64), (256, 128),
                                         (200, 128)])
def test_quantize_int4_planes_bit_identical(jt, k_dim, group):
    w = _normal(4, (k_dim, 96))
    jw, js, jg = jt["int4_plane_probe"].quantize_int4_planes(
        jnp.asarray(w), group=group)
    word, s, g = pp.quantize_int4_planes(torch.from_numpy(w), group=group)
    assert g == jg
    if (k_dim, group) in ((1280, 128), (320, 64)):
        assert (k_dim // 8) % g != 0         # the group straddles planes
    np.testing.assert_array_equal(word.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_activations_bit_identical():
    """The JAX function's activation quantization, written out in jnp."""
    x = _normal(5, (6, 256)) * np.linspace(0.01, 30, 6, dtype=np.float32)[:,
                                                                          None]
    x[2] = 0.0                               # an all-zero row hits the floor
    x2 = jnp.asarray(x)
    xs = jnp.maximum(jnp.max(jnp.abs(x2), axis=-1, keepdims=True), 1e-12)
    xs = xs / 127.0
    xq = jnp.clip(jnp.round(x2 / xs), -127, 127).astype(jnp.int8)
    q, s = wp.quantize_activations(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(xs))


# ---- plain versions vs the Pallas kernels (interpret mode) ------------------

@DTYPES
def test_int4_matmul_v2_plain_matches_pallas(jt, dtype):
    xt, xj, w = _inputs(10, 4, 256, 256, dtype)
    jw, js = jt["int4_layout_ab"].quantize_int4_v2(jnp.asarray(w))
    ref = jt["int4_layout_ab"].int4_matmul_v2(xj, jw, js, interpret=True)
    before = lab.int4_matmul_v2_plain.launches
    got = lab.int4_matmul_v2(xt, torch.from_numpy(np.array(jw)),
                             torch.from_numpy(np.array(js)))
    assert lab.int4_matmul_v2_plain.launches == before + 1
    assert got.dtype == dtype
    _close(got, ref, dtype)


@DTYPES
@pytest.mark.parametrize("k_dim,group", [(256, 128), (320, 64)],
                         ids=["k256", "straddle"])
def test_plane_matmul_plain_matches_pallas(jt, interpret, dtype, k_dim,
                                           group):
    xt, xj, w = _inputs(11, 4, k_dim, 256, dtype)
    jw, js, g = jt["int4_plane_probe"].quantize_int4_planes(
        jnp.asarray(w), group=group)
    ref = jt["int4_plane_probe"].plane_matmul(xj, jw, js, group=g,
                                              block_n=128)
    got = pp.plane_matmul(xt, torch.from_numpy(np.array(jw)),
                          torch.from_numpy(np.array(js)), group=g)
    _close(got, ref, dtype)


@DTYPES
def test_w4a8_plain_matches_pallas(jt, dtype):
    xt, xj, w = _inputs(12, 4, 256, 256, dtype)
    jq, js = jt["w4a8_probe"].quantize_int4(jnp.asarray(w))
    ref = jt["w4a8_probe"].w4a8_matmul(xj, jq, js, interpret=True)
    before = wp.w4a8_matmul_plain.launches
    got = wp.w4a8_matmul(xt, torch.from_numpy(np.array(jq)),
                         torch.from_numpy(np.array(js)))
    assert wp.w4a8_matmul_plain.launches == before + 1
    assert got.dtype == dtype
    _close(got, ref, dtype)


@DTYPES
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_unpack_variants_plain_match_pallas(jt, interpret, dtype, variant):
    xt, xj, w = _inputs(13, 4, 256, 256, dtype)
    jq, js = jt["int4_unpack_probe"].quantize_int4(jnp.asarray(w))
    kernel = getattr(jt["int4_unpack_probe"], f"_kernel_{variant}")
    ref = jt["int4_unpack_probe"].run_variant(kernel, xj, jq, js)
    plain = getattr(up, f"unpack_{variant}_plain")
    before = plain.launches
    got = up.run_variant(variant, xt, torch.from_numpy(np.array(jq)),
                         torch.from_numpy(np.array(js)))
    assert plain.launches == before + 1
    _close(got, ref, dtype)


def test_unpack_v2_rounds_weights_in_x_dtype():
    """v2's bf16 weights are (nib - 8) * bf16(s) rounded to bf16 -- not
    the float32 weights of v1 -- and its plain version is exactly a product
    on them with float32 sums."""
    x = torch.from_numpy(_normal(14, (4, 256))).bfloat16()
    q, s = T4.quantize_int4(torch.from_numpy(_normal(15, (256, 128))))
    wb = T4.dequantize_int4(q, s, torch.bfloat16)
    assert not torch.equal(wb.float(), T4.dequantize_int4(q, s))
    torch.testing.assert_close(up.run_variant("v2", x, q, s),
                               (x.float() @ wb.float()).bfloat16(),
                               rtol=0, atol=0)


# ---- the tools end to end on the CPU ------------------------------------------

def _keys(rows):
    return set().union(*(r.keys() for r in rows))


def test_layout_ab_check_and_bench_on_cpu(tmp_path):
    reset_probe_launches()
    rep = lab.check(device="cpu")
    assert rep["verdict"] == "ok" and rep["rows"][0]["rel"] < 2e-5
    path = tmp_path / "bench.json"
    rep = cli(lab.main, ["bench", "--device", "cpu", "--out", str(path)],
              modes=("bench", "check"))
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    assert rep["verdict"] in ("keep", "reject")
    assert [r["arm"] for r in rep["rows"]] == ["v1-u8", "v2-i32", "bf16"] * 3
    assert {"shape", "arm", "us", "us_l2", "gb_s", "bytes"} <= _keys(
        rep["rows"])
    counts = probe_launch_counts()["int4_word_matmul"]
    assert counts["cuda"] == 0 and counts["plain"] > 0


def test_plane_probe_on_cpu():
    rep = pp.main(device="cpu")
    row = rep["rows"][0]
    tpu_keys = json.loads((REPO / "results" / "int4_plane_probe.json")
                          .read_text()).keys()
    assert set(tpu_keys) <= set(row)
    assert {"us_current_l2", "us_plane_l2"} <= set(row)
    assert row["parity_rel"] < 2e-2 and row["group_plane"] == 128
    assert row["bytes_plane"] == 4 * (256 // 8) * 512 + 4 * 2 * 512
    assert rep["verdict"] == row["verdict"] in ("keep", "reject")


def test_w4a8_probe_on_cpu():
    rep = wp.main(device="cpu")
    assert [r["arm"] for r in rep["rows"]] == [
        "w4a16 (current)", "w4a8 (probe)", "int8 einsum", "bf16 einsum"]
    assert rep["nrmse"] < 1e-2 and "us_activation_quant" in rep
    assert rep["verdict"] in ("keep", "reject")


def test_unpack_probe_on_cpu():
    rep = up.main(device="cpu")
    arms = [r["arm"] for r in rep["rows"]]
    assert arms[0] == "v0 current" and len(arms) == 1 + sum(
        len(v) for v in up.BLOCK_N.values())
    assert set(rep["nrmse"]) == {"v1", "v2"}
    assert max(rep["nrmse"].values()) < 1e-2
    assert rep["verdict"] in ("keep", "reject")


# ---- device rules -----------------------------------------------------------

@pytest.mark.parametrize("name", ["int4_matmul_v2_cuda", "plane_matmul_cuda",
                                  "w4a8_matmul_cuda", "unpack_v1_cuda",
                                  "unpack_v2_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    x = torch.zeros(2, 256)
    q, s = T4.quantize_int4(torch.zeros(256, 128))
    word, ws = lab.quantize_int4_v2(torch.zeros(256, 128))
    calls = {
        "int4_matmul_v2_cuda": lambda: lab.int4_matmul_v2_cuda(x, word, ws),
        "plane_matmul_cuda": lambda: pp.plane_matmul_cuda(x, word, ws,
                                                          group=32),
        "w4a8_matmul_cuda": lambda: wp.w4a8_matmul_cuda(x, q, s),
        "unpack_v1_cuda": lambda: up.unpack_v1_cuda(x, q, s),
        "unpack_v2_cuda": lambda: up.unpack_v2_cuda(x, q, s),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()


def test_run_variant_refuses_unknown_variant_and_block_n():
    x = torch.zeros(2, 256)
    q, s = T4.quantize_int4(torch.zeros(256, 128))
    with pytest.raises(ValueError, match="variant"):
        up.run_variant("v3", x, q, s)
    with pytest.raises(ValueError, match="block_n"):
        up.run_variant("v2", x, q, s, block_n=1024)


@pytest.mark.parametrize("tool", ["int4_layout_ab", "int4_plane_probe",
                                  "w4a8_probe", "int4_unpack_probe"])
def test_tools_default_to_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    mod = {"int4_layout_ab": lab, "int4_plane_probe": pp,
           "w4a8_probe": wp, "int4_unpack_probe": up}[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
