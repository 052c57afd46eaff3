"""Port sequence parallelism (``parallel/sp.py``) vs the JAX package, on
the CPU.

One gloo world of four ranks (``mesh_world.run_world``) runs every case
(``mesh_cases.sp_cases``); the JAX package computes the same functions on
its 8 virtual CPU devices, with ``tests/test_sp.py``'s configurations and
meshes. Tolerances are that file's: the encoder within atol 2e-4 / rtol
1e-3 of JAX's ``encode_sequence_parallel`` (itself exact against the plain
encoder), the fine-tune step's loss and every updated leaf within 1e-4 of
JAX's single-device step. Ring attention's output and its gradients are
held at n_seq 2 and 4 against ``jax.vjp`` of plain softmax attention
within 1e-5: K7/K8 given each block's own logsumexp instead of the global
one would miss that at n_seq > 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from audax.core.config import FineTuneConfig as JaxFineTuneConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models.whisper import init_whisper_params
from audax.parallel.sp import encode_sequence_parallel as jsp_encode
from audax.train import seq2seq as JS
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import params_from_numpy

from .mesh_world import run_world

CFG = JaxWhisperConfig(n_mels=16, n_audio_ctx=32, d_model=32,
                       encoder_layers=2, decoder_layers=1, heads=4,
                       vocab_size=64, n_text_ctx=8)
LONG = JaxWhisperConfig(n_mels=16, n_audio_ctx=64, d_model=32,
                        encoder_layers=2, decoder_layers=1, heads=4,
                        vocab_size=64, n_text_ctx=8)
BAD = JaxWhisperConfig(n_mels=16, n_audio_ctx=17, d_model=32,
                       encoder_layers=1, decoder_layers=1, heads=4,
                       vocab_size=64, n_text_ctx=8)
#: the fine-tune step's runs: (LoRA, FineTuneConfig kwargs, ring)
FULL = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10, lora_rank=0)
RUNS = {"full_ring": (False, FULL, True),
        "full_ulysses": (False, FULL, False),
        "lora_ring": (True, dict(FULL, learning_rate=1e-2, lora_rank=2),
                      True),
        "accum2": (False, dict(FULL, accum_steps=2), True),
        "remat": (False, dict(FULL, gradient_checkpointing=True), True)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jparams, jcfg):
    cfg = WhisperConfig(**jcfg.asdict())
    return params_from_numpy(_np(jparams), cfg, device="cpu"), cfg


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    rng = np.random.default_rng(0)
    jp = init_whisper_params(CFG, jax.random.key(0))
    mel = rng.standard_normal((2, 2 * CFG.n_audio_ctx, 16)).astype(np.float32)
    jlong = init_whisper_params(LONG, jax.random.key(1))
    long_mel = rng.standard_normal((2, 2 * LONG.n_audio_ctx, 16)).astype(
        np.float32)
    qkv = tuple(rng.standard_normal((2, 3, 32, 16)).astype(np.float32)
                for _ in range(4))
    lab = JS.collate_seq2seq([[3, 4, 5, 2], [3, 5, 2], [4, 4, 5, 6],
                              [6, 2]], decoder_start_id=1, pad_multiple=4)
    batch = {"mel": rng.standard_normal(
        (4, 2 * CFG.n_audio_ctx, 16)).astype(np.float32),
        "decoder_input_ids": lab["decoder_input_ids"].astype(np.int64),
        "labels": lab["labels"].astype(np.int64)}
    jbatch = {k: jnp.asarray(v if k == "mel" else v.astype(np.int32))
              for k, v in batch.items()}
    runs, ref = {}, {}
    for name, (lora, kw, ring) in RUNS.items():
        jft = JaxFineTuneConfig(**kw)
        jstate = JS.init_finetune(jp, jft)
        runs[name] = (_np(jstate.trainable) if lora else None, kw, ring)
        st, m = JS.make_finetune_step(CFG, remat=False, donate=False)(
            jstate, jbatch)
        ref[name] = (float(m["loss"]), st.trainable)
    jbad = init_whisper_params(BAD, jax.random.key(0))
    params, cfg = _port(jp, CFG)
    outs = run_world(4, "tests.torch_port.mesh_cases:sp_cases", dict(
        enc=(params, cfg, mel), long=(*_port(jlong, LONG), long_mel),
        qkv=qkv, steps={"model": (params, cfg, batch), "runs": runs},
        bad=(*_port(jbad, BAD), np.zeros((2, 34, 16), np.float32))),
        tmp_path_factory.mktemp("sp"))
    return dict(outs=outs, jp=jp, mel=mel, jlong=jlong, long_mel=long_mel,
                qkv=qkv, ref=ref, jbatch=jbatch)


def test_ranks_agree(sp):
    first = sp["outs"][0]
    for other in sp["outs"][1:]:
        for key in (("enc", "ds", True), ("enc", "dms", False), "long"):
            np.testing.assert_array_equal(other[key], first[key])
        for name in RUNS:
            assert other[("step", name)][0] == first[("step", name)][0]


@pytest.mark.parametrize("mesh", ["ds", "dms"])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "ulysses"])
def test_sp_encoder_matches_jax(sp, mesh, ring):
    """(data 2, seq 2) and (data 1, model 2, seq 2) in the port against
    JAX's (data 2, model 2, seq 2)."""
    ref = jsp_encode(sp["jp"], CFG, jnp.asarray(sp["mel"]),
                     _mesh((2, 2, 2), ("data", "model", "seq")), ring=ring)
    np.testing.assert_allclose(sp["outs"][0][("enc", mesh, ring)],
                               np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_ring_long_sequence_small_blocks(sp):
    """Four frame blocks a layer (16 of 64 frames a rank) against JAX's
    ring on (data 2, seq 4)."""
    ref = jsp_encode(sp["jlong"], LONG, jnp.asarray(sp["long_mel"]),
                     _mesh((2, 4), ("data", "seq")), ring=True)
    np.testing.assert_allclose(sp["outs"][0]["long"], np.asarray(ref),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n_seq", [2, 4])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "ulysses"])
def test_ring_attention_grads_match_jax(sp, n_seq, ring):
    q, k, v, do = (jnp.asarray(a) for a in sp["qkv"])

    def attn(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)

    o, vjp = jax.vjp(attn, q, k, v)
    dq, dk, dv = vjp(do)
    got = sp["outs"][0][("attn", n_seq, ring)]
    for key, want in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[key], np.asarray(want), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(RUNS))
def test_sp_finetune_step_matches_jax(sp, name):
    """One DP x SP step on (data 2, seq 2): the loss and every updated
    leaf against JAX's single-device step (``tests/test_sp.py`` holds
    JAX's own SP step to the same)."""
    loss, mine = sp["outs"][0][("step", name)]
    ref_loss, ref_tree = sp["ref"][name]
    assert abs(loss - ref_loss) < 1e-4
    theirs = (_np(ref_tree) if RUNS[name][0] else jax.tree.map(
        lambda t: t.numpy(), params_from_numpy(
            _np(ref_tree), WhisperConfig(**CFG.asdict()), device="cpu")))
    diffs = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         mine, theirs)
    assert max(jax.tree.leaves(diffs)) < 1e-4


def test_sp_rejects_indivisible_sequence(sp):
    assert "not divisible" in sp["outs"][0]["bad"]
    with pytest.raises(ValueError, match="not divisible"):
        jsp_encode(init_whisper_params(BAD, jax.random.key(0)), BAD,
                   jnp.zeros((2, 34, 16)),
                   _mesh((2, 2, 2), ("data", "model", "seq")))
