"""Port FSDP (ZeRO-3 over torch.distributed) vs the JAX package, on the
CPU.

A four-rank gloo world as a (data 2, model 2) mesh trains the JAX
fine-tune tests' Whisper (``tests/test_fsdp.py``: d_model 32, 1+1 layers)
three steps: whole on every rank, under DP x TP, and in the ZeRO-3 layout
(``fsdp_shard_state``, ``min_size=256`` as the JAX test) with float32,
bfloat16 and int8 moments, and LoRA adapters under FSDP. The JAX package
steps the same batch whole. The losses must agree within rtol 2e-5 (the
JAX test's bound between its FSDP and replicated runs), the trained
parameters within 1e-5, each rank must hold about 1/data of the bytes TP
leaves it, and the float moments must be cut like their parameters; the
int8 first moment stays whole (the same bits on every rank, the whole
run's and JAX's within one code step), its bfloat16 second moment cut,
and the int8 run's parameters are the port's whole int8 run's within 1e-5
(but where rounding moved a code, ``mesh_world.hold_int8_tree``) and JAX's
within ``INT8_UPDATE_REL`` of each leaf's update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audax.core.config import FineTuneConfig as JaxFineTuneConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models.whisper import init_whisper_params
from audax.train.seq2seq import collate_seq2seq
from audax.train.seq2seq import init_finetune as jinit
from audax.train.seq2seq import make_finetune_step as jstep
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import params_from_numpy

from .mesh_world import (INT8_UPDATE_REL, hold_int8_tree,
                         hold_int8_updates, run_world)

JCFG = JaxWhisperConfig(n_mels=16, n_audio_ctx=8, d_model=32,
                        encoder_layers=1, decoder_layers=1, heads=4,
                        vocab_size=64, n_text_ctx=8)
STEPS = 3


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    rng = np.random.default_rng(0)
    jparams = init_whisper_params(JCFG, jax.random.key(0))
    cfg = WhisperConfig(**JCFG.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    b = 8
    mel = rng.standard_normal((b, 2 * JCFG.n_audio_ctx, JCFG.n_mels)) \
        .astype(np.float32)
    lab = collate_seq2seq([[3, 4, 5, 2]] * 4 + [[3, 6, 2]] * 4,
                          decoder_start_id=1, pad_multiple=4)
    batch = {"mel": mel,
             "decoder_input_ids": lab["decoder_input_ids"].astype(np.int64),
             "labels": lab["labels"].astype(np.int64)}
    outs = run_world(4, "tests.torch_port.mesh_cases:fsdp_cases", dict(
        params=params, cfg=cfg, batch=batch, steps=STEPS, model=2),
        tmp_path_factory.mktemp("fsdp"))
    return outs, jparams, batch


def _jax_losses(jparams, batch, moments):
    ft = JaxFineTuneConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10,
                           lora_rank=0, moment_dtype=moments)
    state = jinit(jax.tree.map(jnp.copy, jparams), ft)
    step = jstep(JCFG, remat=False, donate=False)
    jb = {k: jnp.asarray(v, jnp.float32 if k == "mel" else jnp.int32)
          for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        losses.append(float(np.asarray(m["loss"])))
    return losses, state


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_fsdp_steps_match_replicated_and_jax(fsdp, moments):
    outs, jparams, batch = fsdp
    ref, jstate = _jax_losses(jparams, batch, moments)
    for out in outs:
        np.testing.assert_allclose(out[f"ref_{moments}"], ref, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[f"dp_{moments}"], ref, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out[f"fsdp_{moments}"], ref, rtol=2e-5,
                                   atol=1e-6)
    # the whole trained tree gathered from the shards equals JAX's
    mine = outs[0][f"params_{moments}"]
    theirs = params_from_numpy(jax.tree.map(np.asarray, jstate.trainable),
                               WhisperConfig(**JCFG.asdict()), device="cpu")
    if moments != "int8":
        for a, b in zip(_leaves(mine), _leaves(theirs)):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-4)
        return
    # int8: the blocks of m run over each package's own layout of a leaf,
    # and the bridge transposes the conv kernels, so their m rounds in
    # other blocks: each leaf's update p - p0 within INT8_UPDATE_REL of
    # JAX's (by the norm of the difference); the FSDP run equals the
    # port's own whole int8 run within the float bound but where rounding
    # moved a code (``hold_int8_tree``)
    start = params_from_numpy(jax.tree.map(np.asarray, jparams),
                              WhisperConfig(**JCFG.asdict()), device="cpu")
    hold_int8_updates(mine, theirs, start)
    hold_int8_tree(mine, outs[0]["whole_params_int8"], start)
    _hold_int8_mu(outs, jstate)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _decode(q, s, shape):
    """A blockwise int8 leaf decoded to ``shape`` (``optim.py``'s rule)."""
    n = int(np.prod(shape))
    return (q.astype(np.float32) * s[:, None]).reshape(-1)[:n] \
        .reshape(shape)


def _hold_int8_mu(outs, jstate):
    """The int8 first moment stays whole: every rank holds the same codes
    and scales; decoded, each leaf is the port's whole run's within one
    code step of the leaf's largest block (the gradients agree to
    rounding, which can move a code), and (carried into the port's layout
    by the bridge) JAX's replicated one within ``INT8_UPDATE_REL`` by the
    norm (a transposed leaf's m rounds in other blocks)."""
    mine = outs[0]["mu_int8_whole"]
    for out in outs[1:]:
        for part in ("q", "s"):
            for a, b in zip(_leaves(out["mu_int8_whole"][part]),
                            _leaves(mine[part])):
                np.testing.assert_array_equal(a, b)
    whole = outs[0]["whole_mu_int8"]
    for q, s, wq, ws in zip(_leaves(mine["q"]), _leaves(mine["s"]),
                            _leaves(whole["q"]), _leaves(whole["s"])):
        np.testing.assert_allclose(_decode(q, s, (q.size,)),
                                   _decode(wq, ws, (wq.size,)), rtol=0,
                                   atol=1.01 * float(ws.max()) + 1e-12)
    jmu = jax.tree.map(np.asarray, jstate.opt_state[1].mu)
    jtrain = jax.tree.map(np.asarray, jstate.trainable)
    decoded = jax.tree.map(lambda q, s, p: _decode(q, s, p.shape),
                           jmu["q"], jmu["s"], jtrain)
    theirs = _leaves(params_from_numpy(decoded, WhisperConfig(
        **JCFG.asdict()), device="cpu"))
    assert len(theirs) == len(_leaves(mine["q"]))
    for q, s, ref in zip(_leaves(mine["q"]), _leaves(mine["s"]), theirs):
        ref = ref.numpy()
        err = np.linalg.norm(_decode(q, s, ref.shape) - ref)
        assert err <= INT8_UPDATE_REL * np.linalg.norm(ref), (
            err / np.linalg.norm(ref))


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_fsdp_rank_bytes_and_moments(fsdp, moments):
    """Per-rank parameter and moment bytes near 1/(data x model) of the
    whole (the small leaves stay whole), float moments cut like the
    parameters; the int8 first moment is laid out over the whole leaf and
    stays whole on every rank (its bytes are the whole tree's), its
    bfloat16 second moment cut like the parameters."""
    out = fsdp[0][0]
    whole_p, whole_m = out[f"whole_bytes_{moments}"]
    p, m = out[f"bytes_{moments}"]
    assert p < 0.4 * whole_p, (p, whole_p)
    dtype, shape = out[f"mu_{moments}"]
    ndtype, nshape = out[f"nu_{moments}"]
    # q kernel [1, 32, 32]: columns over 'model', rows over 'data'
    assert nshape == (1, 16, 16)
    if moments == "int8":
        assert m == whole_m, (m, whole_m)
        assert (dtype, shape) == ("torch.int8", (4, 256))
        assert ndtype == "torch.bfloat16"
    else:
        assert m < 0.4 * whole_m, (m, whole_m)
        assert dtype == ndtype == f"torch.{moments}"
        assert shape == (1, 16, 16)

def test_fsdp_lora_steps_match_whole(fsdp):
    for out in fsdp[0]:
        np.testing.assert_allclose(out["lora_fsdp"], out["lora_ref"],
                                   rtol=2e-5, atol=1e-6)
        assert out["lora_fsdp"][-1] < out["lora_fsdp"][0]
