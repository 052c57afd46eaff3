"""Port tensor parallelism (Megatron over ``torch.distributed``) vs the JAX
package, on the CPU.

Two gloo worlds serve the module (``mesh_world.run_world``): four ranks as
a (data 2, model 2) mesh run the Whisper cases (int8-moment fine-tune
steps among them), two ranks as (1, 2) the causal-LM cases. Each rank
cuts the same JAX-initialised tree by ``WHISPER_TP_RULES`` /
``CAUSAL_LM_TP_RULES`` and runs the port's entry points with ``mesh=``;
the JAX package computes the same functions whole (its own tests hold its
meshes to that).

Tolerances: the forward within atol 2e-4 / rtol 1e-3 (``tests/
test_parallel.py``'s), greedy and beam tokens and the int4 and beam
Transcribers' text exact, the gradients of the global mean CE within
1e-4 of the largest entry of each leaf -- a row-parallel all-reduce whose
backward all-reduced again would scale them by the model axis, 2x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.beam import beam_search as jbeam
from audax.infer.decode import generate as jgenerate
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models import causal_lm as JLM
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.models.whisper import whisper_forward as jforward
from audax.core.config import FineTuneConfig as JaxFineTuneConfig
from audax.train.seq2seq import init_finetune as jinit
from audax.train.seq2seq import make_finetune_step as jstep
from audax.train.seq2seq import seq2seq_loss
from audax_torch.core.config import WhisperConfig
from audax_torch.models.bridge import causal_lm_from_numpy, params_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig

from .mesh_world import hold_int8_tree, hold_int8_updates, run_world
from .whisper_pair import model as pair_model
from .whisper_pair import tokenizers

JCFG = JaxWhisperConfig(n_mels=16, n_audio_ctx=32, d_model=32,
                        encoder_layers=1, decoder_layers=2, heads=4,
                        vocab_size=90, n_text_ctx=32)
EOS = 23
#: fine-tune steps with int8 Adam moments under TP
INT8_STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def whisper(tmp_path_factory):
    rng = np.random.default_rng(0)
    jparams = init_whisper_params(JCFG, jax.random.key(0))
    cfg = WhisperConfig(**JCFG.asdict())
    params = params_from_numpy(_np(jparams), cfg, device="cpu")
    mel = rng.standard_normal((4, 64, 16)).astype(np.float32)
    tokens = rng.integers(0, 90, (4, 6)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -100)], 1)
    labels[1, 3:] = -100                        # ragged rows
    prompt = np.array([[1, 5, 9]] * 4)
    jtok, tok = tokenizers()
    jcfg_b, jparams_b, _, cfg_b, params_b = pair_model(
        d_model=64, heads=4, encoder_layers=1, decoder_layers=2,
        n_audio_ctx=50, n_text_ctx=32, seed=3)
    t = np.arange(16000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    outs = run_world(4, "tests.torch_port.mesh_cases:tp_whisper", dict(
        params=params, cfg=cfg, mel=mel, tokens=tokens, labels=labels,
        prompt=prompt, eos=EOS, params_big=params_b, cfg_big=cfg_b,
        tok=tok, audio=audio, int8_steps=INT8_STEPS),
        tmp_path_factory.mktemp("tp_whisper"))
    ref = {"jparams": jparams, "jenc": jencode(jparams, JCFG,
                                               jnp.asarray(mel)),
           "jbig": (jcfg_b, jparams_b, jtok)}
    return dict(outs=outs, ref=ref, mel=mel, tokens=tokens, labels=labels,
                prompt=prompt, audio=audio)


def test_ranks_agree(whisper):
    first = whisper["outs"][0]
    for other in whisper["outs"][1:]:
        for key in ("logits", "greedy", "beam", "greedy_kvq", "int4_text"):
            np.testing.assert_array_equal(np.asarray(other[key]),
                                          np.asarray(first[key]))


def test_whisper_forward_matches_jax(whisper):
    ref = jforward(whisper["ref"]["jparams"], JCFG,
                   jnp.asarray(whisper["mel"]),
                   jnp.asarray(whisper["tokens"], jnp.int32))
    np.testing.assert_allclose(whisper["outs"][0]["logits"],
                               np.asarray(ref), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(whisper["outs"][0]["enc"],
                               np.asarray(whisper["ref"]["jenc"]),
                               atol=2e-4, rtol=1e-3)


def test_tp_dp_gradients_match_jax(whisper):
    """The gradient of the global mean CE, the batch's rows over 'data'
    and the heads, FFN and vocab over 'model', equals jax.grad's."""
    mel = jnp.asarray(whisper["mel"])
    tok = jnp.asarray(whisper["tokens"], jnp.int32)
    lab = jnp.asarray(whisper["labels"], jnp.int32)

    def loss(p):
        return seq2seq_loss(jforward(p, JCFG, mel, tok), lab)

    value, grads = jax.value_and_grad(loss)(whisper["ref"]["jparams"])
    out = whisper["outs"][0]
    np.testing.assert_allclose(out["loss"], float(value), rtol=1e-5)
    ours = params_from_numpy(_np(grads), WhisperConfig(**JCFG.asdict()),
                             device="cpu")

    def check(path, mine, theirs):
        theirs = theirs.numpy()
        scale = max(float(np.abs(theirs).max()), 1e-6)
        err = float(np.abs(mine - theirs).max()) / scale
        assert err < 1e-4, (path, err)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            check(path, a, b)

    walk(out["grads"], ours)


def test_tp_greedy_and_int8_kv_match_jax(whisper):
    enc = whisper["ref"]["jenc"]
    prompt = jnp.asarray(whisper["prompt"], jnp.int32)
    for key, kv_quant in (("greedy", False), ("greedy_kvq", True)):
        ref = jgenerate(whisper["ref"]["jparams"], JCFG, enc, prompt,
                        max_len=12, eos_id=EOS, kv_quant=kv_quant)
        np.testing.assert_array_equal(whisper["outs"][0][key],
                                      np.asarray(ref.tokens))


def test_tp_beam_matches_jax(whisper):
    ref = jbeam(whisper["ref"]["jparams"], JCFG, whisper["ref"]["jenc"],
                jnp.asarray(whisper["prompt"], jnp.int32), max_len=12,
                eos_id=EOS, beam_width=3)
    np.testing.assert_array_equal(whisper["outs"][0]["beam"],
                                  np.asarray(ref.tokens))
    np.testing.assert_allclose(whisper["outs"][0]["beam_scores"],
                               np.asarray(ref.scores), atol=1e-5)


def test_tp_int4_and_beam_transcribers_match_jax(whisper):
    """int4 blocks stay whole over 'model' (K9 whole on every rank, the
    caches every head); the float beam Transcriber runs head-parallel."""
    jcfg, jparams, jtok = whisper["ref"]["jbig"]
    for key, kw in (("int4_text", dict(quantize="int4")),
                    ("beam_text", dict(beam_width=2))):
        jtr = JaxTranscriber(jparams, jcfg, jtok, max_new_tokens=6,
                             temperature_fallback=False, backend="xla",
                             **kw)
        assert whisper["outs"][0][key] == jtr.transcribe(
            whisper["audio"]).text


def test_tp_int8_moments_match_whole_and_jax(whisper):
    """int8 Adam moments under (data 2 x model 2): each blockwise m stays
    whole on every rank ([blocks, 256] of the whole q kernel) while v is
    cut like its parameter. The losses equal the whole run's and JAX's
    (rtol 2e-5, ``test_torch_fsdp.py``'s bound); the trained tree
    gathered from the blocks equals the whole run's within 1e-5 but where
    rounding moved an int8 code (``hold_int8_tree``), and each of its
    leaves' updates JAX's (``hold_int8_updates``)."""
    ft = JaxFineTuneConfig(learning_rate=1e-3, warmup_steps=1, max_steps=10,
                           lora_rank=0, moment_dtype="int8")
    state = jinit(jax.tree.map(jnp.copy, whisper["ref"]["jparams"]), ft)
    step = jstep(JCFG, remat=False, donate=False)
    batch = {"mel": jnp.asarray(whisper["mel"]),
             "decoder_input_ids": jnp.asarray(whisper["tokens"], jnp.int32),
             "labels": jnp.asarray(whisper["labels"], jnp.int32)}
    ref = []
    for _ in range(INT8_STEPS):
        state, m = step(state, batch)
        ref.append(float(np.asarray(m["loss"])))
    start = params_from_numpy(_np(whisper["ref"]["jparams"]),
                              WhisperConfig(**JCFG.asdict()), device="cpu")
    theirs = params_from_numpy(_np(state.trainable),
                               WhisperConfig(**JCFG.asdict()), device="cpu")
    for out in whisper["outs"]:
        got = out["int8"]
        for run in ("whole", "tp"):
            np.testing.assert_allclose(got[run]["losses"], ref, rtol=2e-5,
                                       atol=1e-6)
        # the decoder's q kernel [2, 32, 32]: 2048 elements in 8 blocks,
        # v's columns cut over 'model'
        assert got["tp"]["mu"] == got["whole"]["mu"] == (8, 256)
        assert got["tp"]["nu"] == (2, 32, 16)
        hold_int8_tree(got["tp"]["params"], got["whole"]["params"], start)
        hold_int8_updates(got["tp"]["params"], theirs, start)


# ---------------------------------------------------------------- LM ------
LM_CFGS = [dict(vocab_size=128, d_model=64, layers=2, heads=4, kv_heads=2,
                ffn_dim=128, qk_norm=True, tie_embeddings=True),
           # one KV head over model=2: the head's width is cut in two
           dict(vocab_size=64, d_model=32, layers=1, heads=2, kv_heads=1,
                ffn_dim=64, qk_norm=True, tie_embeddings=False)]
LM_STEPS = 6


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, (2, 8)).astype(np.int64)
    models, refs = [], []
    for i, kw in enumerate(LM_CFGS):
        jcfg = JLM.CausalLMConfig(**kw)
        jparams = JLM.init_causal_lm(jcfg, jax.random.key(i))
        cfg = CausalLMConfig(**kw)
        models.append((causal_lm_from_numpy(_np(jparams), cfg,
                                            device="cpu"), cfg))
        refs.append((jcfg, jparams))
    outs = run_world(2, "tests.torch_port.mesh_cases:tp_lm",
                     dict(models=models, tokens=tokens, steps=LM_STEPS),
                     tmp_path_factory.mktemp("tp_lm"))
    return outs, refs, tokens


def _jax_greedy(jparams, jcfg, tokens):
    b = tokens.shape[0]
    cache = JLM.init_lm_cache(jcfg, b, LM_STEPS + 2)
    cur = jnp.asarray(tokens[:, 0], jnp.int32)
    seq = []
    for pos in range(LM_STEPS):
        emb = JLM.embed_tokens(jparams, cur[:, None])[:, 0]
        logits, cache = JLM.lm_decode_step(jparams, jcfg, emb,
                                           jnp.int32(pos), cache)
        cur = jnp.argmax(logits, -1)
        seq.append(np.asarray(cur))
    return np.stack(seq, 1)


@pytest.mark.parametrize("i", range(len(LM_CFGS)), ids=["kv2", "kv1"])
def test_causal_lm_tp_matches_jax(lm, i):
    outs, refs, tokens = lm
    jcfg, jparams = refs[i]
    ref = JLM.lm_forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    for out in outs:
        np.testing.assert_allclose(out[i]["logits"], np.asarray(ref),
                                   atol=2e-4, rtol=1e-3)
        np.testing.assert_array_equal(out[i]["greedy"],
                                      _jax_greedy(jparams, jcfg, tokens))
    kv = LM_CFGS[i]["kv_heads"] * (LM_CFGS[i]["d_model"]
                                   // LM_CFGS[i]["heads"])
    # the k projection is cut over 'model' in both cases (kv_heads 1: a
    # head's width in two, as JAX's rule does)
    assert outs[0][i]["k_local"][-1] == kv // 2


# ----------------------------------------------------------- C7 ----------
C7 = JaxWhisperConfig(n_mels=16, n_audio_ctx=32, d_model=48,
                      encoder_layers=1, decoder_layers=2, heads=3,
                      vocab_size=90, n_text_ctx=32)
C7_LM = dict(vocab_size=64, d_model=48, layers=2, heads=3, kv_heads=1,
             ffn_dim=64, qk_norm=True, tie_embeddings=True)


@pytest.fixture(scope="module")
def c7(tmp_path_factory):
    """3 heads over a model axis of 2 (d_model 48 divides, the heads do
    not): every attention projection stays whole, the MLP is cut."""
    rng = np.random.default_rng(7)
    jparams = init_whisper_params(C7, jax.random.key(7))
    cfg = WhisperConfig(**C7.asdict())
    mel = rng.standard_normal((2, 64, 16)).astype(np.float32)
    tokens = rng.integers(0, 90, (2, 6)).astype(np.int64)
    prompt = np.array([[1, 5, 9]] * 2)
    jlm_cfg = JLM.CausalLMConfig(**C7_LM)
    jlm = JLM.init_causal_lm(jlm_cfg, jax.random.key(8))
    lm_tokens = rng.integers(0, 64, (2, 8)).astype(np.int64)
    outs = run_world(2, "tests.torch_port.mesh_cases:tp_c7", dict(
        params=params_from_numpy(_np(jparams), cfg, device="cpu"), cfg=cfg,
        mel=mel, tokens=tokens, prompt=prompt, eos=EOS,
        lm_params=causal_lm_from_numpy(_np(jlm), CausalLMConfig(**C7_LM),
                                       device="cpu"),
        lm_cfg=CausalLMConfig(**C7_LM), lm_tokens=lm_tokens, steps=LM_STEPS),
        tmp_path_factory.mktemp("tp_c7"))
    return dict(outs=outs, jparams=jparams, mel=mel, tokens=tokens,
                prompt=prompt, jlm=(jlm_cfg, jlm), lm_tokens=lm_tokens)


def test_tp_indivisible_heads_match_jax(c7):
    """Whisper's forward, encoder states and greedy tokens at 3 heads over
    TP 2 against JAX (which runs the same whole), on both ranks."""
    mel = jnp.asarray(c7["mel"])
    logits = jforward(c7["jparams"], C7, mel,
                      jnp.asarray(c7["tokens"], jnp.int32))
    enc = jencode(c7["jparams"], C7, mel)
    greedy = jgenerate(c7["jparams"], C7, enc,
                       jnp.asarray(c7["prompt"], jnp.int32), max_len=12,
                       eos_id=EOS).tokens
    for out in c7["outs"]:
        np.testing.assert_allclose(out["logits"], np.asarray(logits),
                                   atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(out["enc"], np.asarray(enc), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_array_equal(out["greedy"], np.asarray(greedy))
        assert out["q_local"] == (1, 48, 48)       # whole: all 3 heads
        assert out["mlp_local"] == (1, 48, 96)     # cut: 192 / 2
        assert out["local_heads"] == 3
        # the width cut alone splits a head, which attention refuses
        assert out["width_cut"] is not None


def test_tp_indivisible_heads_causal_lm_matches_jax(c7):
    jcfg, jparams = c7["jlm"]
    tokens = c7["lm_tokens"]
    ref = JLM.lm_forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    for out in c7["outs"]:
        np.testing.assert_allclose(out["lm"]["logits"], np.asarray(ref),
                                   atol=2e-4, rtol=1e-3)
        np.testing.assert_array_equal(out["lm"]["greedy"],
                                      _jax_greedy(jparams, jcfg, tokens))
        assert out["lm"]["k_local"] == (2, 48, 16)  # whole: the one KV head
