"""Port pipeline parallelism (``parallel/pp.py``) vs the JAX package, on
the CPU.

One gloo world of four ranks (``mesh_world.run_world``) runs every case
(``mesh_cases.pp_cases``): 4 stages, or (stage 2, data 2). The JAX
package computes the same functions with ``tests/test_pp.py``'s
configurations, on its own ("stage",) and ("stage", "data") meshes where
that file does, else whole. Tolerances are that file's: forwards within
atol 2e-4 / rtol 1e-3, every gradient leaf (the embedding included: an
output broadcast or embedding whose gradient came out S x or 0 x would
miss it) within atol 2e-5 / rtol 1e-3, the train step's losses within
1e-5 and its parameters within atol 5e-5 / rtol 1e-3 of the replicated
AdamW step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import causal_lm as JLM
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.parallel.pp import encode_pipelined as jencode_pp
from audax.parallel.pp import lm_forward_pipelined as jlm_pp
from audax.parallel.pp import make_pp_lm_train_step as jpp_step
from audax.parallel.pp import pp_layer_specs as jpp_specs
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import causal_lm_from_numpy, params_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig

from .mesh_world import run_world

CFG = JaxWhisperConfig(n_mels=16, n_audio_ctx=16, d_model=32,
                       encoder_layers=4, decoder_layers=1, heads=4,
                       vocab_size=64, n_text_ctx=8)
LM = dict(vocab_size=120, d_model=32, layers=4, heads=4, kv_heads=2,
          ffn_dim=64, qkv_bias=True, qk_norm=False, tie_embeddings=True,
          rope_theta=1e4)
JLM_CFG = JLM.CausalLMConfig(**LM)
ENC_RUNS = ((2, 2), (2, 4), (4, 4))
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_port(tree):
    return jax.tree.map(lambda t: t.numpy(), causal_lm_from_numpy(
        _np(tree), CausalLMConfig(**LM), device="cpu"))


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


def _ce(logits, labels):
    """The independent oracle of ``tests/test_pp.py``: masked mean CE."""
    valid = labels >= 0
    lse = jax.nn.log_softmax(logits, -1)
    ll = jnp.take_along_axis(lse, jnp.maximum(labels, 0)[..., None],
                             -1)[..., 0]
    return -(ll * valid).sum() / jnp.maximum(valid.sum(), 1)


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    rng = np.random.default_rng(0)
    jp = init_whisper_params(CFG, jax.random.key(0))
    mel = rng.standard_normal((8, 2 * CFG.n_audio_ctx, 16)).astype(np.float32)
    jlm = JLM.init_causal_lm(JLM_CFG, jax.random.key(0))
    tokens = rng.integers(0, 120, (4, 9)).astype(np.int64)
    mask = rng.integers(0, 2, (4, 9)).astype(np.int64)
    mask[:, 0] = 1
    grad_tokens = rng.integers(0, 120, (4, 8)).astype(np.int64)
    toks_pp = rng.integers(0, 120, (8, 10)).astype(np.int64)
    toks_pp[:, 7:] = -100                       # collator pad mask
    toks_dp = rng.integers(0, 120, (8, 9)).astype(np.int64)
    p1 = JLM.init_causal_lm(JLM_CFG, jax.random.key(1))
    p3 = JLM.init_causal_lm(JLM_CFG, jax.random.key(3))
    train = {"pp": (toks_pp, 3, LR, causal_lm_from_numpy(
                 _np(p1), CausalLMConfig(**LM), device="cpu")),
             "pp_dp": (toks_dp, 2, LR, causal_lm_from_numpy(
                 _np(p3), CausalLMConfig(**LM), device="cpu"))}
    cfg = WhisperConfig(**CFG.asdict())
    outs = run_world(4, "tests.torch_port.mesh_cases:pp_cases", dict(
        enc=(params_from_numpy(_np(jp), cfg, device="cpu"), cfg, mel),
        enc_runs=ENC_RUNS,
        lm=(causal_lm_from_numpy(_np(jlm), CausalLMConfig(**LM),
                                 device="cpu"), CausalLMConfig(**LM)),
        tokens=tokens, mask=mask, grad_tokens=grad_tokens, train=train),
        tmp_path_factory.mktemp("pp"))
    return dict(outs=outs, jp=jp, mel=mel, jlm=jlm, tokens=tokens, mask=mask,
                grad_tokens=grad_tokens, toks_pp=toks_pp, toks_dp=toks_dp,
                p1=p1, p3=p3)


def test_ranks_agree(pp):
    first = pp["outs"][0]
    for other in pp["outs"][1:]:
        for key in [("enc",) + r for r in ENC_RUNS] + [("lm", 4)]:
            np.testing.assert_array_equal(other[key], first[key])


@pytest.mark.parametrize("stages,n_micro", ENC_RUNS)
def test_encode_pipelined_matches_jax(pp, stages, n_micro):
    mel = jnp.asarray(pp["mel"][:2 * n_micro])
    ref = jencode_pp(pp["jp"], CFG, mel, _mesh((stages,), ("stage",)),
                     n_micro=n_micro)
    got = pp["outs"][0][("enc", stages, n_micro)]
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jencode(pp["jp"], CFG, mel)),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_lm_pipelined_matches_jax(pp, stages, masked):
    toks = jnp.asarray(pp["tokens"], jnp.int32)
    kw = {"attention_mask": jnp.asarray(pp["mask"], jnp.int32)} \
        if masked else {}
    ref = jlm_pp(pp["jlm"], JLM_CFG, toks, _mesh((stages,), ("stage",)),
                 n_micro=2, **kw)
    np.testing.assert_allclose(
        pp["outs"][0][("lm_mask" if masked else "lm", stages)],
        np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_pp_lm_grads_match_jax(pp, remat):
    """Every leaf's gradient, the embedding and each stage's layers
    included, against jax.grad of the plain forward."""
    toks = jnp.asarray(pp["grad_tokens"], jnp.int32)

    def ce(p):
        logits = JLM.lm_forward(p, JLM_CFG, toks[:, :-1])
        lse = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(lse, toks[:, 1:, None], -1).mean()

    want = _lm_port(jax.grad(ce)(pp["jlm"]))
    for out in pp["outs"]:          # every stage's embedding and norm too
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, atol=2e-5, rtol=1e-3), out[("grads", remat)], want)


@pytest.mark.parametrize("name", ["pp", "pp_dp"])
def test_pp_train_step_matches_replicated(pp, name):
    """The train step over 4 stages, and PP x DP on (stage 2, data 2),
    against the replicated AdamW step (and JAX's own PP step on its
    meshes): every step's loss and every trained leaf."""
    toks = jnp.asarray(pp["toks_pp" if name == "pp" else "toks_dp"],
                       jnp.int32)
    p0 = pp["p1" if name == "pp" else "p3"]
    steps = 3 if name == "pp" else 2
    opt = optax.adamw(LR)

    def loss_pl(p, tk):
        return _ce(JLM.lm_forward(p, JLM_CFG, jnp.maximum(tk[:, :-1], 0)),
                   tk[:, 1:])

    p_pl, s_pl, losses = p0, opt.init(p0), []
    for _ in range(steps):
        l_pl, g = jax.value_and_grad(loss_pl)(p_pl, toks)
        up, s_pl = opt.update(g, s_pl, p_pl)
        p_pl = optax.apply_updates(p_pl, up)
        losses.append(float(l_pl))
    mesh = (_mesh((4,), ("stage",)) if name == "pp"
            else _mesh((2, 4), ("stage", "data")))
    jstep = jpp_step(JLM_CFG, mesh, opt, n_micro=2, remat=True,
                     data_axis=None if name == "pp" else "data")
    p_j = jax.device_put(p0, jpp_specs(p0, mesh))
    s_j = jax.device_put(opt.init(p0), jpp_specs(opt.init(p0), mesh))
    jl = []
    for _ in range(steps):
        p_j, s_j, l_j = jstep(p_j, s_j, toks)
        jl.append(float(l_j))
    got, trained, q_local = pp["outs"][0][("train", name)]
    np.testing.assert_allclose(got, losses, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, jl, atol=1e-5, rtol=1e-5)
    assert got[-1] < got[0]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=5e-5, rtol=1e-3), trained, _lm_port(p_pl))
    # the memory win: each rank holds its stage's layers only
    stages = 4 if name == "pp" else 2
    assert q_local[0] == LM["layers"] // stages


def test_pp_rejects_bad_divisibility(pp):
    layers, batch, lm_batch = pp["outs"][0]["errors"]
    assert layers == "6 layers not divisible by 4 stages"
    assert batch == "batch 4 not divisible by n_micro=3"
    assert lm_batch == "batch 3 not divisible by n_micro=2"
    with pytest.raises(ValueError, match="not divisible"):
        jencode_pp(pp["jp"], CFG, jnp.zeros((4, 32, 16)),
                   _mesh((2,), ("stage",)), n_micro=3)
