"""The port's rule tables and spec trees (``parallel/sharding.py``,
``parallel/fsdp.py``) vs the JAX package's, on the CPU.

The port's ``param_specs`` and ``fsdp_specs`` must give JAX's spec tree,
spec for spec, for the Whisper, Qwen3, Qwen3-MoE and int4 trees (the
port's trees bridged or quantized from the same JAX draw), the same
divisibility fallbacks, and ``kv_rows`` JAX's ``constrain_kv`` rows. The
JAX side uses a mesh of its eight virtual CPU devices; the port's spec
computations read only a mesh's axis names and sizes, so a stand-in with
the same axes serves, and its ranks pick the local blocks ``shard_params``
cuts, which must be JAX's shards of the same arrays.
"""

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import causal_lm as JLM
from audax.models.quantize import quantize_tree as jquantize
from audax.models.whisper import init_whisper_params
from audax.parallel import fsdp as JF
from audax.parallel import sharding as JS
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import causal_lm_from_numpy, params_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.models.quantize import quantize_tree
from audax_torch.parallel import fsdp as F
from audax_torch.parallel import sharding as S


class FakeMesh:
    """The axis names, sizes and this rank's coordinates of a mesh."""

    def __init__(self, shape, coords=None):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())
        self._coords = coords or {}

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, name):
        return self._coords.get(name, 0)


def jmesh(data, model):
    devs = np.array(jax.devices()[: data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


JW = JaxWhisperConfig(n_mels=16, n_audio_ctx=8, d_model=64,
                      encoder_layers=1, decoder_layers=2, heads=4,
                      vocab_size=96, n_text_ctx=8)
LM = dict(vocab_size=128, d_model=64, layers=2, heads=4, kv_heads=2,
          ffn_dim=128, qk_norm=True, tie_embeddings=False)
MOE = dict(vocab_size=96, d_model=32, layers=2, heads=4, kv_heads=2,
           ffn_dim=64, qk_norm=True, num_experts=4, experts_per_tok=2,
           moe_ffn_dim=48)


def _trees():
    jw = init_whisper_params(JW, jax.random.key(0))
    w = params_from_numpy(jax.tree.map(np.asarray, jw),
                          WhisperConfig(**JW.asdict()), device="cpu")
    out = {"whisper": (jw, w, JS.WHISPER_TP_RULES, S.WHISPER_TP_RULES)}
    for name, kw in (("qwen3", LM), ("moe", MOE)):
        jp = JLM.init_causal_lm(JLM.CausalLMConfig(**kw), jax.random.key(1))
        p = causal_lm_from_numpy(jax.tree.map(np.asarray, jp),
                                 CausalLMConfig(**kw), device="cpu")
        out[name] = (jp, p, JS.CAUSAL_LM_TP_RULES, S.CAUSAL_LM_TP_RULES)
    out["whisper_int4"] = (jquantize(jw, bits=4), quantize_tree(w, bits=4),
                           JS.WHISPER_TP_RULES, S.WHISPER_TP_RULES)
    out["moe_int8"] = (jquantize(out["moe"][0], bits=8),
                       quantize_tree(out["moe"][1], bits=8),
                       JS.CAUSAL_LM_TP_RULES, S.CAUSAL_LM_TP_RULES)
    return out


TREES = _trees()


def _flat(tree, prefix=""):
    """{path: spec tuple} of a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


def _jflat(specs):
    return {JS._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))}


def _same_paths(ours, theirs):
    assert set(ours) == set(theirs), set(ours) ^ set(theirs)


@pytest.mark.parametrize("name", list(TREES))
def test_param_specs_match_jax(name):
    jtree, tree, jrules, rules = TREES[name]
    ours = _flat(S.param_specs(tree, rules))
    theirs = _jflat(JS.param_specs(jtree, jrules))
    _same_paths(ours, theirs)
    for path in theirs:
        assert ours[path] == theirs[path], path


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("name", list(TREES))
def test_fsdp_specs_match_jax(name, shape):
    jtree, tree, jrules, rules = TREES[name]
    data, model = shape
    ours = _flat(F.fsdp_specs(tree, FakeMesh({"data": data, "model": model}),
                              rules=rules, min_size=256))
    theirs = _jflat(JF.fsdp_specs(jtree, jmesh(data, model), rules=jrules,
                                  min_size=256))
    _same_paths(ours, theirs)
    for path in theirs:
        if "conv" in path and "kernel" in path:
            continue           # [C_out, C_in, 3] here, [3, C_in, C_out] there
        assert ours[path] == theirs[path], path


def test_indivisible_dims_fall_back_to_replication():
    """d_model 24 / 3 heads / vocab 101 over model 2 (tests/
    test_parallel.py's case): what does not divide stays whole."""
    jcfg = JaxWhisperConfig(n_mels=16, n_audio_ctx=8, d_model=24,
                            encoder_layers=1, decoder_layers=1, heads=3,
                            vocab_size=101, n_text_ctx=8)
    jp = init_whisper_params(jcfg, jax.random.key(0))
    p = params_from_numpy(jax.tree.map(np.asarray, jp),
                          WhisperConfig(**jcfg.asdict()), device="cpu")
    mesh = jmesh(1, 2)
    jsharded = JS.shard_params(jp, mesh)
    theirs = {JS._path_str(k): tuple(v.sharding.spec) for k, v in
              jax.tree_util.tree_leaves_with_path(jsharded)}
    ours = _flat(S.tp_specs(p, FakeMesh({"data": 1, "model": 2})))
    for path, spec in theirs.items():
        assert ours[path] == spec or (not any(spec) and not any(
            ours[path])), path
    assert not any(ours["decoder/embed"])                # 101 rows


@pytest.mark.parametrize("coords", [(0, 0), (1, 1), (0, 1)])
def test_shard_params_blocks_are_jax_shards(coords):
    """The block ``shard_params`` cuts for rank (data, model) is JAX's
    shard of the same leaf on that device."""
    jtree, tree, jrules, rules = TREES["qwen3"]
    mesh = jmesh(2, 2)
    jsharded = JS.shard_params(jtree, mesh, rules=jrules)
    dev = mesh.devices[coords]
    local = S.shard_params(tree, FakeMesh({"data": 2, "model": 2},
                                          dict(zip(("data", "model"),
                                                   coords))), rules)
    for key in ("q", "k", "o", "gate", "down"):
        jleaf = jsharded["layers"][key]["kernel"]
        shard = [s for s in jleaf.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(local["layers"][key]["kernel"].numpy(),
                                      np.asarray(shard.data))
    jshard = [s for s in jsharded["embed"].addressable_shards
              if s.device == dev][0]
    np.testing.assert_array_equal(local["embed"].numpy(),
                                  np.asarray(jshard.data))


@pytest.mark.parametrize("heads,batch", [(4, 8), (3, 8), (4, 3), (3, 3)])
def test_constrain_kv_layout_matches_jax(heads, batch):
    """``kv_rows``, the slot rule the decoders and both continuous engines
    cut their state by, gives every rank JAX's ``constrain_kv`` rows of
    the batch dim (the heads follow the projections' split, held by the
    TP tests)."""
    mesh = jmesh(2, 2)
    x = np.zeros((1, batch, heads, 4, 2), np.float32)
    jx = JS.constrain_kv(mesh, heads, batch, x, put=True)
    for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
        fake = FakeMesh({"data": 2, "model": 2},
                        dict(zip(("data", "model"), coords)))
        shard = [s for s in jx.addressable_shards
                 if s.device == mesh.devices[coords]][0]
        rows = S.kv_rows(fake, batch)
        want = range(batch)[shard.index[1]]
        got = range(batch) if rows is None else range(batch)[rows]
        assert got == want, coords


# ------------------------------------------- C7: heads the axis splits ------
@pytest.mark.parametrize("heads,whole", [(3, True), (6, False)])
def test_tp_specs_keep_attention_whole_at_indivisible_heads(heads, whole):
    """At d_model 96 over model 2, 3 heads would be cut inside a head:
    every attention projection stays whole (the MLP is still cut); 6
    heads divide and take the rule tables' specs. ``heads=None`` is the
    width-only cut."""
    cfg = JaxWhisperConfig(n_mels=16, n_audio_ctx=8, d_model=96,
                           encoder_layers=1, decoder_layers=1, heads=heads,
                           vocab_size=96, n_text_ctx=8)
    tree = params_from_numpy(jax.tree.map(
        np.asarray, init_whisper_params(cfg, jax.random.key(0))),
        WhisperConfig(**cfg.asdict()), device="cpu")
    mesh = FakeMesh({"data": 1, "model": 2})
    specs = _flat(S.tp_specs(tree, mesh, heads=heads))
    width = _flat(S.tp_specs(tree, mesh))
    for path, spec in specs.items():
        attn = re.search(S.ATTENTION_LEAVES, path)
        assert spec == (S.P() if whole and attn else width[path]), path
    assert specs["encoder/layers/mlp_in/kernel"] == S.P(None, None, "model")
    local = S.shard_params(tree, mesh, heads=heads)
    q = local["decoder"]["layers"]["attn"]["q"]["kernel"]
    assert q.shape[-1] == (96 if whole else 48)
