"""Port expert parallelism vs the JAX package, on the CPU.

A four-rank gloo world runs the port's ``moe_expert_parallel`` (the GShard
all_to_all dispatch over a 'model' axis of 4) and the expert-sharded dense
MoE forward (``CAUSAL_LM_TP_RULES``, experts over 'model'); the JAX package
runs its own ``moe_expert_parallel`` on a mesh of four of its eight virtual
CPU devices. Both hold the same JAX-initialised Qwen3-MoE layer
(``tests/test_moe.py``'s ``MOE_TINY``) and inputs. At capacity factor 0 the
dispatch is exact and also equals the single-device ``_moe_block``; at 1.0
and 0.5 each rank drops the tokens that overflow its capacity, and the port
must drop the same ones as JAX (within 1e-5). int4 experts raise, as in
JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audax.core.config import MeshConfig as JaxMeshConfig
from audax.models import causal_lm as JLM
from audax.parallel.ep import moe_expert_parallel as jep
from audax.parallel.mesh import make_mesh as jmake_mesh
from audax_torch.models.bridge import causal_lm_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.models.whisper import layer_params

from .mesh_world import run_world

KW = dict(vocab_size=96, d_model=32, layers=2, heads=4, kv_heads=2,
          ffn_dim=64, qk_norm=True, num_experts=4, experts_per_tok=2,
          moe_ffn_dim=48)
FACTORS = (0.0, 1.0, 0.5)


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    rng = np.random.default_rng(0)
    jcfg = JLM.CausalLMConfig(**KW)
    jparams = JLM.init_causal_lm(jcfg, jax.random.key(0))
    cfg = CausalLMConfig(**KW)
    params = causal_lm_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    tokens = rng.integers(0, 96, (2, 7)).astype(np.int64)
    dense = dataclasses.replace(cfg, moe_impl="dense")
    outs = run_world(4, "tests.torch_port.mesh_cases:ep_cases", dict(
        layer=layer_params(params["layers"], 0), cfg=cfg, x=x,
        factors=FACTORS, moe_params=params, moe_cfg=dense, tokens=tokens),
        tmp_path_factory.mktemp("ep"))
    return outs, jcfg, jparams, x, tokens


def _jax(jcfg, jparams, x, cf):
    mesh = jmake_mesh(JaxMeshConfig(model=4), devices=jax.devices()[:4])
    layer0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    return np.asarray(jep(layer0, jcfg, jnp.asarray(x), mesh,
                          capacity_factor=cf))


@pytest.mark.parametrize("cf", FACTORS, ids=["cf0", "cf1", "cf0.5"])
def test_all_to_all_matches_jax(ep, cf):
    outs, jcfg, jparams, x, _ = ep
    ref = _jax(jcfg, jparams, x, cf)
    for out in outs:
        np.testing.assert_allclose(out[cf], ref, atol=1e-5, rtol=1e-4)
    if cf == 0.0:
        layer0 = jax.tree.map(lambda a: a[0], jparams["layers"])
        whole = np.asarray(JLM._moe_block(layer0, jcfg, jnp.asarray(x)))
        np.testing.assert_allclose(outs[0][cf], whole, atol=1e-5, rtol=1e-4)
    if cf == 0.5:                       # tokens really were dropped
        assert np.abs(outs[0][cf] - outs[0][0.0]).max() > 1e-3


def test_all_to_all_gradient_matches_jax(ep):
    """The backward of both exchanges is the reverse exchange: d(sum y^2)
    / dx equals JAX's."""
    outs, jcfg, jparams, x, _ = ep
    mesh = jmake_mesh(JaxMeshConfig(model=4), devices=jax.devices()[:4])
    layer0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    g = jax.grad(lambda v: jnp.sum(jep(layer0, jcfg, v, mesh) ** 2))(
        jnp.asarray(x))
    np.testing.assert_allclose(outs[0]["x_grad"], np.asarray(g), atol=1e-4,
                               rtol=1e-3)


def test_expert_sharded_dense_matches_jax(ep):
    outs, jcfg, jparams, _, tokens = ep
    dense = dataclasses.replace(jcfg, moe_impl="dense")
    ref = np.asarray(JLM.lm_forward(jparams, dense,
                                    jnp.asarray(tokens, jnp.int32)))
    for out in outs:
        np.testing.assert_allclose(out["dense_tp"], ref, atol=2e-5,
                                   rtol=1e-4)


def test_int4_experts_raise(ep):
    assert "int4 experts" in ep[0][0]["int4_error"]
