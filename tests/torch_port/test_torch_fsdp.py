"""Port FSDP (ZeRO-3 over torch.distributed) vs the JAX package, on the
CPU.

A four-rank gloo world as a (data 2, model 2) mesh trains the JAX
fine-tune tests' Whisper (``tests/test_fsdp.py``: d_model 32, 1+1 layers)
three steps: whole on every rank, under DP x TP, and in the ZeRO-3 layout
(``fsdp_shard_state``, ``min_size=256`` as the JAX test) with float32 and
bfloat16 moments, and LoRA adapters under FSDP. The JAX package steps the
same batch whole. The losses must agree within rtol 2e-5 (the JAX test's
bound between its FSDP and replicated runs), the trained parameters
within 1e-5, each rank must hold about 1/data of the bytes TP leaves it,
and the bfloat16 moments must be cut like their parameters.
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

from .mesh_world import run_world

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


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
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

    def walk(a, b):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
        else:
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-4)

    walk(mine, theirs)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_fsdp_rank_bytes_and_moments(fsdp, moments):
    """Per-rank parameter and moment bytes near 1/(data x model) of the
    whole (the small leaves stay whole), bf16 moments cut like the
    parameters."""
    out = fsdp[0][0]
    whole_p, whole_m = out[f"whole_bytes_{moments}"]
    p, m = out[f"bytes_{moments}"]
    assert p < 0.4 * whole_p and m < 0.4 * whole_m, (p, whole_p, m, whole_m)
    dtype, shape = out[f"mu_{moments}"]
    assert dtype == f"torch.{moments}"
    # q kernel [1, 32, 32]: columns over 'model', rows over 'data'
    assert shape == (1, 16, 16)


def test_fsdp_lora_steps_match_whole(fsdp):
    for out in fsdp[0]:
        np.testing.assert_allclose(out["lora_fsdp"], out["lora_ref"],
                                   rtol=2e-5, atol=1e-6)
        assert out["lora_fsdp"][-1] < out["lora_fsdp"][0]
