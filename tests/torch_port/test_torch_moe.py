"""The causal LM's mixture-of-experts paths (``audax_torch/models/
causal_lm.py``: the router, the ``ragged`` and ``dense`` impls, the router
logits, ``load_balance_loss``, the decode step's selected scan, the HF
Qwen3-MoE port) against the JAX package's ``audax/models/causal_lm.py`` on
the CPU.

The model is ``tests/test_moe.py``'s ``MOE_TINY`` (d 32, 2 layers, 4/2
heads, 4 experts, top 2, expert FFN 48), its weights drawn by JAX and
carried into the port through ``causal_lm_from_numpy``; tokens from a
numpy seed. float32 within 1e-4. The experts each token selects are
compared before any output: ``torch.topk`` does not promise JAX's order
of ties, so a test that meets a near-tie reports the margin (it does not
re-seed). Quantized experts (int8, int4) are quantized on both sides from
the same float tree and the leaves held equal; JAX's int4 decode runs
kernel K9 in Pallas interpret mode (the ``pallas_k9`` fixture), its
selected scan with a traced expert index.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.models import causal_lm as J
from audax.models import quantize as JQ
from audax.ops import int4_matmul as J4
from audax_torch.models import causal_lm as P
from audax_torch.models import quantize as PQ
from audax_torch.models.bridge import causal_lm_from_numpy
from audax_torch.models.whisper import layer_params, tree_leaves

TOL = 1e-4
MOE_TINY = dict(vocab_size=96, d_model=32, layers=2, heads=4, kv_heads=2,
                ffn_dim=64, qk_norm=True, tie_embeddings=True,
                rope_theta=1e6, num_experts=4, experts_per_tok=2,
                moe_ffn_dim=48)


def _pair(seed=0, **over):
    kw = dict(MOE_TINY, **over)
    jcfg, cfg = J.CausalLMConfig(**kw), P.CausalLMConfig(**kw)
    jp = J.init_causal_lm(jcfg, jax.random.key(seed))
    p = causal_lm_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, MOE_TINY["vocab_size"],
                                                shape)


def _selected(router_logits, k):
    """(top-k expert ids [L, N, k], the smallest gap between the k-th and
    the (k+1)-th probability of any token) of router logits [L, N, E]."""
    probs = torch.softmax(torch.as_tensor(np.asarray(router_logits)).float(),
                          -1)
    top = torch.topk(probs, k + 1, -1)
    return top.indices[..., :k], float((top.values[..., k - 1]
                                        - top.values[..., k]).min())


@pytest.fixture
def pallas_k9(monkeypatch):
    """JAX's ``int4_matmul`` on its Pallas kernel in interpret mode (its
    own ``interpret=False`` argument overridden)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(J4, "_ENV_BACKEND", "pallas")
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_forward_and_router_logits_match_jax(impl, norm_topk):
    jcfg, jp, cfg, p = _pair(moe_impl=impl, norm_topk_prob=norm_topk)
    tokens = _tokens(1, (2, 9))
    jl, jrl = J.lm_forward(jp, jcfg, jnp.asarray(tokens),
                           return_router_logits=True)
    logits, rl = P.lm_forward(p, cfg, torch.from_numpy(tokens),
                              return_router_logits=True)
    assert rl.shape == (2, 18, 4) == jrl.shape
    np.testing.assert_allclose(rl.numpy(), np.asarray(jrl), atol=TOL, rtol=0)
    ours, margin = _selected(rl.detach(), 2)
    theirs, _ = _selected(jrl, 2)
    assert torch.equal(ours, theirs), f"top-k differs (margin {margin:.2e})"
    # JAX's own top-k on its logits picks the same experts
    jtop = np.asarray(jax.lax.top_k(jax.nn.softmax(jrl, -1), 2)[1])
    np.testing.assert_array_equal(ours.numpy(), jtop)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=TOL, rtol=0)
    # the plain forward (no router logits) gives the same logits
    torch.testing.assert_close(P.lm_forward(p, cfg,
                                            torch.from_numpy(tokens)),
                               logits.detach(), atol=0, rtol=0)


def test_impls_agree():
    _, _, cfg, p = _pair()
    tokens = torch.from_numpy(_tokens(2, (2, 7)))
    ragged = P.lm_forward(p, cfg, tokens)
    dense = P.lm_forward(p, dataclasses.replace(cfg, moe_impl="dense"),
                         tokens)
    torch.testing.assert_close(ragged, dense, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="moe_impl"):
        P.lm_forward(p, dataclasses.replace(cfg, moe_impl="gshard"), tokens)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_decode_matches_full_and_jax(impl):
    jcfg, jp, cfg, p = _pair(moe_impl=impl)
    tokens = _tokens(3, (2, 5))
    full = P.lm_forward(p, cfg, torch.from_numpy(tokens))
    cache = P.init_lm_cache(cfg, 2, 8, device="cpu")
    jcache = J.init_lm_cache(jcfg, 2, 8)
    for t in range(5):
        emb = P.embed_tokens(p, torch.from_numpy(tokens[:, t]))
        out, cache = P.lm_decode_step(p, cfg, emb, t, cache)
        ref, jcache = J.lm_decode_step(
            jp, jcfg, J.embed_tokens(jp, jnp.asarray(tokens[:, t])),
            jnp.int32(t), jcache)
        torch.testing.assert_close(out, full[:, t], atol=TOL, rtol=0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=f"step {t}")


def test_init_layout_and_order():
    """The port's own draw has JAX's tree (shapes, leaf order) and scales;
    the MoE fields come with the config."""
    cfg = P.CausalLMConfig(**MOE_TINY)
    p = P.init_causal_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = J.init_causal_lm(J.CausalLMConfig(**MOE_TINY), jax.random.key(0))
    assert P.tree_map(lambda t: tuple(t.shape), p) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
    assert list(p["layers"])[:8] == ["attn_norm", "q", "k", "v", "o",
                                     "mlp_norm", "router", "experts"]
    ek = p["layers"]["experts"]
    assert float(ek["down"]["kernel"].std()) == pytest.approx(48 ** -0.5,
                                                              rel=0.05)
    assert cfg.moe_ffn == 48 and P.CausalLMConfig().moe_ffn == 768
    big = P.CausalLMConfig.qwen3_30b_a3b()
    assert (big.d_model, big.layers, big.heads, big.kv_heads, big.head_dim,
            big.num_experts, big.experts_per_tok, big.moe_ffn,
            big.vocab_size, big.tie_embeddings) == (
        2048, 48, 32, 4, 128, 128, 8, 768, 151936, False)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_experts_match_jax(bits, pallas_k9):
    """int8 / int4 experts: ``quantize_tree``'s leaves equal JAX's (the 4-D
    expert kernels quantized, the router kept float); the prefill through
    whole dequantization (both impls) and the decode steps through the
    selected scan (N k <= E) equal JAX's, and greedy tokens are equal."""
    jcfg, jp, cfg, p = _pair()
    jq = JQ.quantize_tree(jp, bits=bits)
    q = PQ.quantize_tree(p, bits=bits)
    jleaves = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert len(jleaves) == len(tree_leaves(q))
    for path, leaf in jleaves:
        node = q
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=str(path))
    assert "kernel" in q["layers"]["router"]
    key = "kernel_q4" if bits == 4 else "kernel_q"
    assert q["layers"]["experts"]["gate"][key].dim() == 4
    tokens = _tokens(4, (2, 7))
    for impl in ("ragged", "dense"):
        jc, c = (dataclasses.replace(jcfg, moe_impl=impl),
                 dataclasses.replace(cfg, moe_impl=impl))
        ref = np.asarray(J.lm_forward(jq, jc, jnp.asarray(tokens)))
        got = P.lm_forward(q, c, torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0, err_msg=impl)
    # greedy decode, one slot each (1 x 2 <= 4: the selected scan)
    steps = 6
    jtok, ptok = [int(tokens[0, 0])], [int(tokens[0, 0])]
    jcache = J.init_lm_cache(jcfg, 1, steps + 1)
    cache = P.init_lm_cache(cfg, 1, steps + 1, device="cpu")
    for t in range(steps):
        ref, jcache = J.lm_decode_step(
            jq, jcfg, J.embed_tokens(jq, jnp.asarray([jtok[-1]])),
            jnp.int32(t), jcache)
        out, cache = P.lm_decode_step(
            q, cfg, P.embed_tokens(q, torch.tensor([ptok[-1]])), t, cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=f"step {t}")
        jtok.append(int(np.asarray(ref).argmax(-1)[0]))
        ptok.append(int(out.argmax(-1)[0]))
    assert ptok == jtok


def test_selected_scan_matches_jax_and_the_block(pallas_k9):
    """``_moe_selected_scan`` on one layer's int4 experts against JAX's
    (a jitted call: the expert index is traced into K9's scalar prefetch)
    and against the port's own ragged block on the same experts."""
    jcfg, jp, cfg, p = _pair()
    jq, q = JQ.quantize_tree(jp, bits=4), PQ.quantize_tree(p, bits=4)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    idx = np.array([[3, 1], [0, 3]])
    w = np.array([[0.7, 0.3], [0.4, 0.6]], np.float32)
    jex = jax.tree.map(lambda a: a[1], jq["layers"]["experts"])
    ref = jax.jit(lambda *a: J._moe_selected_scan(jex, jcfg, *a))(
        jnp.asarray(h), jnp.asarray(idx), jnp.asarray(w))
    ex = layer_params(q["layers"], 1)["experts"]
    got = P._moe_selected_scan(ex, cfg, torch.from_numpy(h),
                               torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    # float32 experts: the same slots through index_select
    jf = jax.tree.map(lambda a: a[1], jp["layers"]["experts"])
    ref_f = J._moe_selected_scan(jf, jcfg, jnp.asarray(h), jnp.asarray(idx),
                                 jnp.asarray(w))
    got_f = P._moe_selected_scan(layer_params(p["layers"], 1)["experts"],
                                 cfg, torch.from_numpy(h),
                                 torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), atol=TOL,
                               rtol=0)


def test_selected_scan_reads_nothing_on_the_host(monkeypatch):
    """No ``item``, ``tolist`` or ``__int__`` on any tensor while the scan
    runs: the expert ids stay where the router wrote them (on the card,
    the device; K9 reads its index itself)."""
    _, _, cfg, p = _pair()
    q = PQ.quantize_tree(p, bits=4)
    layer = layer_params(q["layers"], 0)
    h = torch.randn(2, cfg.d_model)
    w, idx, _ = P._moe_router(layer, cfg, h)
    ref = P._moe_selected_scan(layer["experts"], cfg, h, idx, w)
    calls = []
    for name in ("item", "tolist", "__int__", "__index__", "__bool__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _o=orig: (calls.append(_n),
                                                _o(self, *a))[1])
    got = P._moe_selected_scan(layer["experts"], cfg, h, idx, w)
    monkeypatch.undo()
    assert calls == []
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_load_balance_loss_and_grad_match_jax(masked):
    jcfg, jp, cfg, p = _pair()
    tokens = _tokens(6, (2, 8))
    am = None
    if masked:
        am = np.ones((2, 8), np.int32)
        am[1, 5:] = 0

    def jloss(params):
        _, rl = J.lm_forward(params, jcfg, jnp.asarray(tokens),
                             attention_mask=None if am is None
                             else jnp.asarray(am),
                             return_router_logits=True)
        return J.load_balance_loss(rl, 4, 2, None if am is None
                                   else jnp.asarray(am))

    ref, jg = jax.value_and_grad(jloss)(jp)
    router = p["layers"]["router"]["kernel"].requires_grad_(True)
    _, rl = P.lm_forward(p, cfg, torch.from_numpy(tokens),
                         attention_mask=None if am is None
                         else torch.from_numpy(am),
                         return_router_logits=True)
    got = P.load_balance_loss(rl, 4, 2, None if am is None
                              else torch.from_numpy(am))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), abs=TOL)
    jr = np.asarray(jg["layers"]["router"]["kernel"])
    assert np.abs(jr).max() > 0
    np.testing.assert_allclose(router.grad.numpy(), jr,
                               atol=TOL * np.abs(jr).max(), rtol=0)


def _hf_qwen3_moe(norm_topk_prob=True, mlp_only_layers=()):
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    hc = transformers.Qwen3MoeConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
        moe_intermediate_size=48, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=norm_topk_prob, decoder_sparse_step=1,
        mlp_only_layers=list(mlp_only_layers), head_dim=8, rope_theta=1e6,
        tie_word_embeddings=True, max_position_embeddings=64,
        attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.Qwen3MoeForCausalLM(hc).eval()


@pytest.mark.parametrize("norm_topk", [True, False])
def test_port_from_hf_qwen3_moe(norm_topk):
    hf = _hf_qwen3_moe(norm_topk)
    params, cfg = P.port_causal_lm_from_hf(hf, device="cpu")
    jparams, jcfg = J.port_causal_lm_from_hf(hf)
    assert (cfg.num_experts, cfg.experts_per_tok, cfg.moe_ffn,
            cfg.norm_topk_prob) == (4, 2, 48, norm_topk)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tokens = _tokens(7, (2, 9))
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens)).logits.numpy()
    ours = P.lm_forward(params, cfg, torch.from_numpy(tokens)).numpy()
    ref = np.asarray(J.lm_forward(jparams, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_port_from_hf_refuses_mixed_stacks():
    hf = _hf_qwen3_moe(mlp_only_layers=[0])
    with pytest.raises(NotImplementedError, match="mixed"):
        P.port_causal_lm_from_hf(hf, device="cpu")
    with pytest.raises(NotImplementedError):
        J.port_causal_lm_from_hf(hf)


def _jax_probe(name, **shape):
    """A JAX MoE probe from ``tools/`` (imported by path), its module
    constants set to ``shape``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[2] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, val in shape.items():
        setattr(mod, key, val)
    return mod


def test_moe_decode_probe_arms_match_the_jax_probes():
    """The tool's arms against the four JAX probes' functions on the same
    float32 inputs (their shape constants cut to d 64, E 8, k 2, f 48)."""
    from audax_torch.tools import moe_decode_probe as MP
    d, e, k, f = 64, 8, 2, 48
    shape = dict(D=d, E=e, K=k, FE=f, DTYPE=jnp.float32)
    p1, p2, p4 = (_jax_probe(n, **shape) for n in (
        "moe_decode_probe", "moe_decode_probe2", "moe_decode_probe4"))
    rng = np.random.default_rng(9)
    w = {"gate": rng.standard_normal((e, d, f)), "up":
         rng.standard_normal((e, d, f)), "down": rng.standard_normal((e, f, d))}
    w = {m: (t / np.sqrt(t.shape[1])).astype(np.float32) for m, t in w.items()}
    h = rng.standard_normal((3, d)).astype(np.float32)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(3)])
    wgt = rng.dirichlet(np.ones(k), 3).astype(np.float32)
    jw = {m: jnp.asarray(t) for m, t in w.items()}
    pw = {m: {"kernel": torch.from_numpy(t)} for m, t in w.items()}
    ja = (jnp.asarray(h), jnp.asarray(idx), jnp.asarray(wgt))
    pa = (torch.from_numpy(h), torch.from_numpy(idx), torch.from_numpy(wgt))
    for ours, ref in ((MP.ragged(pa[0], pw, *pa[1:]), p1.ragged_impl(jw, *ja)),
                      (MP.dense(pa[0], pw, *pa[1:]), p1.dense_impl(jw, *ja)),
                      (MP.gather(pa[0], pw, *pa[1:]), p1.gather_impl(jw, *ja)),
                      (MP.slice_scan(pa[0], pw, *pa[1:]),
                       p2.slice_impl(jw, *ja)),
                      (MP.k_slice(pa[0], pw, *pa[1:]),
                       p2.slice_impl(jw, *ja))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0)
    q8 = {m: PQ.quantize_matrix(pw[m]["kernel"], axis=-2) for m in pw}
    jq = {m: {"q": jnp.asarray(q.numpy()), "scale": jnp.asarray(s.numpy())}
          for m, (q, s) in q8.items()}
    pq = {m: {"kernel_q": q, "kernel_scale": s} for m, (q, s) in q8.items()}
    np.testing.assert_allclose(
        MP.ragged(pa[0], {m: {"kernel_q": q.float(), "kernel_scale": s}
                          for m, (q, s) in q8.items()}, *pa[1:]).numpy(),
        np.asarray(p4.ragged_int8(ja[0], jq, *ja[1:])), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        MP.slice_scan(pa[0], pq, *pa[1:]).numpy(),
        np.asarray(p4.slice_int8(ja[0], jq, *ja[1:])), atol=TOL, rtol=0)


def test_moe_decode_probe_runs_on_the_cpu(tmp_path):
    """``python -m audax_torch.tools.moe_decode_probe --device cpu``: every
    arm at each n, held against ragged, its floor beside it; the int4 arm
    ran K9's plain version; the report is written."""
    import json

    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.tools import cli
    from audax_torch.tools import moe_decode_probe as MP
    reset_launches()
    out = tmp_path / "moe.json"
    rep = cli(MP.main, ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["tool"] == "moe_decode_probe"
    rows = rep["rows"]
    assert {(r["arm"], r["n"]) for r in rows} == {
        (a, n) for a in MP.ARMS for n in MP.SHAPES["cpu"][4]}
    assert all(r["max_rel_err"] <= MP.TOL and r["floor_us"] > 0
               for r in rows)
    dense = [r for r in rows if r["arm"] == "dense"]
    assert all(r["bytes"] == 8 * 3 * 64 * 48 * 2 for r in dense)
    assert launch_counts()["int4_matmul"]["plain"] > 0
    assert "fastest" in rep["verdict"]
