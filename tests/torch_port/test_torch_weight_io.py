"""Weight I/O on the CPU: the port's HF file reader and writer
(``models/hf_files.py``), its ports (``models/port.py``,
``models/causal_lm.py:port_causal_lm_state_dict``) and exports
(``models/export.py``), and the ``convert-hf``, ``export-hf`` and
``verify-parity`` commands, against the JAX package and against
``transformers``/``safetensors`` themselves.

Models are random, built from tiny configs (Whisper 2+2 layers at d 64;
Qwen2, Qwen3 and Qwen3-MoE at 2 layers). The ported trees equal
``models/bridge.py`` of the JAX package's port of the same state dict leaf
for leaf and bit for bit; the exported state dicts equal JAX's key for key
and bit for bit; a directory the port writes loads with
``from_pretrained`` and gives logits within 1e-4 of the port's forward.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from audax.cli import main as jax_cli
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import causal_lm as JLM
from audax.models import export as JE
from audax.models import port as JP
from audax.models.whisper import init_whisper_params as jax_init_whisper
from audax.train.checkpoints import save_pytree as jax_save_pytree
from audax_torch.cli import main as cli
from audax_torch.core.config import WhisperConfig
from audax_torch.models import causal_lm as CL
from audax_torch.models import export as E
from audax_torch.models import hf_files as H
from audax_torch.models import port as P
from audax_torch.models.bridge import causal_lm_from_numpy, params_from_numpy
from audax_torch.models.whisper import (init_whisper_params, tree_leaves,
                                        tree_map, whisper_forward)
from audax_torch.train.checkpoints import load_pytree, save_pytree

TINY = WhisperConfig(n_mels=16, n_audio_ctx=32, d_model=64, encoder_layers=2,
                     decoder_layers=2, heads=2, vocab_size=111, n_text_ctx=24)
#: logits of an exported directory under from_pretrained vs the port's
TOL_LOGITS = 1e-4


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_paths(v, p) if isinstance(v, dict) else {p: v})
    return out


def _assert_trees_equal(got, want):
    g, w = _paths(got), _paths(want)
    assert g.keys() == w.keys()
    for k in w:
        a = torch.as_tensor(np.asarray(g[k]) if not isinstance(
            g[k], torch.Tensor) else g[k])
        b = torch.as_tensor(np.asarray(w[k]) if not isinstance(
            w[k], torch.Tensor) else w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def _hf_whisper(seed=0):
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    hf_cfg = HFConfig(**JE.hf_whisper_config_dict(JaxWhisperConfig(
        **dataclasses.asdict(TINY))))
    torch.manual_seed(seed)
    return WhisperForConditionalGeneration(hf_cfg).eval()


def _hf_lm(kind, tie=True, seed=0):
    import transformers as T
    common = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=64, rope_theta=1e4, rms_norm_eps=1e-6,
                  tie_word_embeddings=tie, max_position_embeddings=64,
                  attn_implementation="eager")
    if kind == "qwen2":
        model = T.Qwen2ForCausalLM(T.Qwen2Config(**common))
    elif kind == "qwen3":
        model = T.Qwen3ForCausalLM(T.Qwen3Config(head_dim=16, **common))
    else:
        model = T.Qwen3MoeForCausalLM(T.Qwen3MoeConfig(
            head_dim=8, num_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=16, norm_topk_prob=True,
            decoder_sparse_step=1, mlp_only_layers=[], **common))
    torch.manual_seed(seed)
    for p in model.parameters():            # every leaf random, norms too
        torch.nn.init.normal_(p, std=0.2)
    return model.eval()


LMS = [("qwen2", True), ("qwen2", False), ("qwen3", True), ("moe", True),
       ("moe", False)]


# ---- hf_files against safetensors and transformers ------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64, torch.int8,
                                   torch.uint8, torch.bool])
def test_reads_safetensors_save_file(tmp_path, dtype):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(1)
    tensors = {"a": torch.randn(3, 5, generator=g),
               "b.c": torch.randn(7, generator=g),
               "scalar": torch.randn((), generator=g),
               "empty": torch.zeros(0, 4)}
    tensors = {k: (v * 50).to(dtype) for k, v in tensors.items()}
    save_file(tensors, str(tmp_path / "model.safetensors"),
              metadata={"format": "pt"})
    got = H.read_state_dict(str(tmp_path))
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_safe_open_reads_what_hf_files_writes(tmp_path, fmt):
    """What ``write_state_dict`` writes loads in ``safetensors.safe_open``
    (or ``torch.load``) and back through ``read_state_dict``."""
    from safetensors import safe_open
    g = torch.Generator().manual_seed(2)
    tensors = {"w": torch.randn(8, 16, generator=g).t(),   # a strided view
               "h": torch.randn(20, generator=g).to(torch.bfloat16),
               "i": torch.arange(12).reshape(3, 4),
               "s": torch.randn(4, 4, 4, generator=g)[1]}
    path = H.write_state_dict(str(tmp_path), tensors, format=fmt)
    if fmt == "safetensors":
        with safe_open(path, framework="pt") as fh:
            assert fh.metadata() == {"format": "pt"}
            seen = {k: fh.get_tensor(k) for k in fh.keys()}
    else:
        seen = torch.load(path, weights_only=True)
    back = H.read_state_dict(str(tmp_path))
    assert back.format == fmt
    assert seen.keys() == tensors.keys() == set(back)
    for k, v in tensors.items():
        assert torch.equal(seen[k], v) and torch.equal(back[k], v), k


@pytest.mark.parametrize("layout", ["safetensors", "sharded", "bin",
                                    "sharded-bin", "bf16"])
def test_port_whisper_of_saved_dir_matches_jax(tmp_path, layout):
    """``save_pretrained`` writes the directory; the port reads it without
    transformers and equals the bridge of JAX's port of the live model's
    state dict, bit for bit (bf16: both upcast the same bf16 values)."""
    hf = _hf_whisper()
    if layout == "bf16":
        hf = hf.to(torch.bfloat16)
    kw = {"safe_serialization": "bin" not in layout}
    if layout.startswith("sharded"):
        kw["max_shard_size"] = "100KB"
    hf.save_pretrained(str(tmp_path), **kw)
    index = ("model.safetensors.index.json" if kw["safe_serialization"]
             else "pytorch_model.bin.index.json")
    assert os.path.exists(tmp_path / index) == layout.startswith("sharded")
    sd = H.read_state_dict(str(tmp_path))
    assert sd.format == ("safetensors" if kw["safe_serialization"] else "bin")
    cfg = P.whisper_config_from_hf(H.read_config(str(tmp_path)))
    assert cfg == P.whisper_config_from_hf(hf.config) == TINY
    got = P.port_whisper_state_dict(sd, cfg, device="cpu")
    jsd = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in hf.model.state_dict().items()}
    want = params_from_numpy(jax.tree.map(
        np.asarray, JP.port_whisper_state_dict(jsd, JaxWhisperConfig(
            **dataclasses.asdict(TINY)))), cfg, device="cpu")
    _assert_trees_equal(got, want)
    _assert_trees_equal(P.port_whisper_from_hf(hf.float(), device="cpu"),
                        want)


@pytest.mark.parametrize("kind,tie", LMS)
def test_port_causal_lm_state_dict_matches_jax(tmp_path, kind, tie):
    hf = _hf_lm(kind, tie)
    hf.save_pretrained(str(tmp_path))
    got, cfg = CL.port_causal_lm_state_dict(
        H.read_state_dict(str(tmp_path)), H.read_config(str(tmp_path)),
        device="cpu")
    jparams, jcfg = JLM.port_causal_lm_from_hf(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = causal_lm_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    _assert_trees_equal(got, want)
    live, live_cfg = CL.port_causal_lm_from_hf(hf, device="cpu")
    assert live_cfg == cfg
    _assert_trees_equal(live, want)


# ---- export against JAX's export ------------------------------------------
def test_export_whisper_matches_jax_and_round_trips():
    hf = _hf_whisper(seed=3)
    params = P.port_whisper_from_hf(hf, device="cpu")
    got = E.export_whisper_state_dict(params, TINY)
    jparams = JP.port_whisper_from_hf(hf)
    want = JE.export_whisper_state_dict(jparams, JaxWhisperConfig(
        **dataclasses.asdict(TINY)))
    src = hf.state_dict()
    assert list(got) == list(want) and set(got) == set(src)
    for k in want:
        assert torch.equal(got[k].contiguous(),
                           torch.from_numpy(np.array(want[k]))), k
        assert torch.equal(got[k], src[k]), k
    assert E.hf_whisper_config_dict(TINY) == JE.hf_whisper_config_dict(
        JaxWhisperConfig(**dataclasses.asdict(TINY)))


@pytest.mark.parametrize("kind,tie", LMS)
def test_export_causal_lm_matches_jax_and_round_trips(kind, tie):
    hf = _hf_lm(kind, tie, seed=4)
    params, cfg = CL.port_causal_lm_from_hf(hf, device="cpu")
    got = E.export_causal_lm_state_dict(params, cfg)
    jparams, jcfg = JLM.port_causal_lm_from_hf(hf)
    want = JE.export_causal_lm_state_dict(jparams, jcfg)
    src = hf.state_dict()
    assert list(got) == list(want) and set(got) == set(src)
    for k in want:
        assert torch.equal(got[k].contiguous(),
                           torch.from_numpy(np.array(want[k]))), k
        assert torch.equal(got[k], src[k]), k
    assert E.hf_causal_lm_config_dict(cfg) == JE.hf_causal_lm_config_dict(
        jcfg)


@pytest.mark.parametrize("vocab", [111, 51864, 51865, 51866])
def test_whisper_config_dict_matches_jax(vocab):
    cfg = dataclasses.replace(TINY, vocab_size=vocab)
    d = E.hf_whisper_config_dict(cfg)
    assert d == JE.hf_whisper_config_dict(JaxWhisperConfig(
        **dataclasses.asdict(cfg)))
    assert P.whisper_config_from_hf(d) == cfg


@pytest.mark.parametrize("ffn,moe_ffn,experts", [(0, 0, 2), (64, 0, 0),
                                                 (0, 16, 4)])
def test_lm_config_dict_matches_jax(ffn, moe_ffn, experts):
    kw = dict(vocab_size=64, d_model=96, layers=1, heads=2, kv_heads=1,
              ffn_dim=ffn, num_experts=experts,
              experts_per_tok=1 if experts else 0, moe_ffn_dim=moe_ffn)
    d = E.hf_causal_lm_config_dict(CL.CausalLMConfig(**kw))
    assert d == JE.hf_causal_lm_config_dict(JLM.CausalLMConfig(**kw))
    assert d["intermediate_size"] > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_export_rejects_quantized_tree(bits):
    from audax_torch.models.quantize import quantize_tree
    params = init_whisper_params(TINY, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        E.export_whisper_state_dict(quantize_tree(params, bits=bits), TINY)


# ---- the command lines ------------------------------------------------------
def _jax_ckpt(tmp_path, name="jckpt", cfg=TINY, dtype=None):
    params = jax_init_whisper(JaxWhisperConfig(**dataclasses.asdict(cfg)),
                              jax.random.key(0))
    if dtype is not None:
        params = jax.tree.map(lambda x: x.astype(dtype), params)
    path = str(tmp_path / name)
    jax_save_pytree(path, params)
    with open(path + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh)
    return path, params


@pytest.mark.parametrize("kind,quant", [("whisper", None), ("whisper", "int8"),
                                        ("whisper", "int4"),
                                        ("causal-lm", None),
                                        ("causal-lm", "int4")])
def test_convert_hf_matches_jax(tmp_path, kind, quant):
    """The port's ``convert-hf`` (no transformers) writes the bridge of the
    JAX command's tree, bit for bit, and the same sidecar."""
    hf = _hf_whisper(seed=5) if kind == "whisper" else _hf_lm("moe", seed=5)
    hf_dir = str(tmp_path / "hf")
    hf.save_pretrained(hf_dir)
    extra = ["--quantize", quant] if quant else []
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert cli.main(["convert-hf", "--hf-dir", hf_dir, "--out", ours,
                     "--kind", kind] + extra) == 0
    assert jax_cli._COMMANDS["convert-hf"](
        ["--hf-dir", hf_dir, "--out", theirs, "--kind", kind] + extra) == 0
    with open(ours + ".config.json") as fh:
        dims = json.load(fh)
    with open(theirs + ".config.json") as fh:
        assert dims == json.load(fh)
    got = load_pytree(ours)
    raw = load_pytree(theirs)           # the JAX tree, through read_orbax
    if kind == "whisper":
        want = params_from_numpy(raw, WhisperConfig(**dims), device="cpu")
    elif quant:                         # codes and scales, no layout change
        want = raw
    else:
        want = causal_lm_from_numpy(raw, CL.CausalLMConfig(**dims),
                                    device="cpu")
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_export_hf_round_trip_loads_in_transformers(tmp_path, fmt):
    """port checkpoint + sidecar -> ``export-hf`` -> ``from_pretrained``:
    weights intact, proj_out re-tied, logits within 1e-4 of the port's
    forward; ``convert-hf`` of the directory gives the tree back bit for
    bit."""
    from transformers import WhisperForConditionalGeneration
    params = init_whisper_params(TINY, torch.Generator().manual_seed(6),
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_pytree(ckpt, params)
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(TINY), fh)
    out = str(tmp_path / "hf")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", out,
                     "--format", fmt]) == 0
    fname = "model.safetensors" if fmt == "safetensors" else \
        "pytorch_model.bin"
    assert os.path.exists(os.path.join(out, fname))
    if fmt == "safetensors":
        assert "proj_out.weight" not in H.read_state_dict(out)
    hf = WhisperForConditionalGeneration.from_pretrained(out).eval()
    embed = params["decoder"]["embed"]
    assert torch.equal(hf.model.decoder.embed_tokens.weight, embed)
    assert torch.equal(hf.proj_out.weight, embed)
    assert torch.equal(hf.model.encoder.conv1.weight,
                       params["encoder"]["conv1"]["kernel"])
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (1, 2 * TINY.n_audio_ctx, TINY.n_mels)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, TINY.vocab_size, (1, 8)))
    with torch.no_grad():
        ref = hf(input_features=mel.transpose(1, 2),
                 decoder_input_ids=toks).logits
        got = whisper_forward(params, TINY, mel, toks)
    assert float((got - ref).abs().max()) <= TOL_LOGITS
    back = str(tmp_path / "back")
    assert cli.main(["convert-hf", "--hf-dir", out, "--out", back]) == 0
    _assert_trees_equal(load_pytree(back), params)


@pytest.mark.parametrize("kind,tie", [("qwen3", True), ("moe", False)])
def test_export_hf_causal_lm_loads_in_transformers(tmp_path, kind, tie):
    import transformers as T
    hf0 = _hf_lm(kind, tie, seed=7)
    params, cfg = CL.port_causal_lm_from_hf(hf0, device="cpu")
    ckpt = str(tmp_path / "lm")
    save_pytree(ckpt, params)
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh)
    out = str(tmp_path / "hf")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", out,
                     "--kind", "causal-lm"]) == 0
    hf = T.AutoModelForCausalLM.from_pretrained(out).eval()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 12)))
    with torch.no_grad():
        ref = hf(input_ids=toks).logits
        got = CL.lm_forward(params, cfg, toks)
    assert float((got - ref).abs().max()) <= TOL_LOGITS


def test_export_hf_of_jax_checkpoint_matches_jax(tmp_path):
    """A JAX orbax checkpoint exported by both command lines: the same
    config.json and the same tensors, bit for bit."""
    ckpt, _ = _jax_ckpt(tmp_path)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", ours]) == 0
    assert jax_cli._COMMANDS["export-hf"](["--ckpt", ckpt,
                                           "--out", theirs]) == 0
    assert H.read_config(ours) == H.read_config(theirs)
    a, b = H.read_state_dict(ours), H.read_state_dict(theirs)
    assert set(a) == set(b)
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_export_hf_merges_lora(tmp_path):
    """``--lora-ckpt`` folds the adapter into the exported weights, as the
    JAX command does (both read the same orbax base and adapter)."""
    from audax.models.lora import init_lora
    ckpt, jparams = _jax_ckpt(tmp_path)
    lora = init_lora(jparams, rank=2, targets=["attn/q", "attn/v"],
                     rng=jax.random.key(1))
    lora = jax.tree.map(lambda x: x + 0.01, lora)
    lck = str(tmp_path / "lora")
    jax_save_pytree(lck, lora)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", ours,
                     "--lora-ckpt", lck]) == 0
    assert jax_cli._COMMANDS["export-hf"](["--ckpt", ckpt, "--out", theirs,
                                           "--lora-ckpt", lck]) == 0
    a, b = H.read_state_dict(ours), H.read_state_dict(theirs)
    q = "model.encoder.layers.0.self_attn.q_proj.weight"
    base = np.asarray(jparams["encoder"]["layers"]["attn"]["q"]["kernel"])[0]
    assert float((a[q] - torch.from_numpy(base.T)).abs().max()) > 0
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_export_hf_upcasts_bf16(tmp_path):
    ckpt, jparams = _jax_ckpt(tmp_path, dtype=jax.numpy.bfloat16)
    out = str(tmp_path / "hf")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", out]) == 0
    sd = H.read_state_dict(out)
    embed = sd["model.decoder.embed_tokens.weight"]
    assert embed.dtype == torch.float32
    np.testing.assert_array_equal(
        embed.numpy(),
        np.asarray(jparams["decoder"]["embed"]).astype(np.float32))
    # the port's own bf16 tree too
    params = tree_map(lambda t: t.to(torch.bfloat16), init_whisper_params(
        TINY, torch.Generator().manual_seed(0), device="cpu"))
    ck2 = str(tmp_path / "bf16")
    save_pytree(ck2, params)
    out2 = str(tmp_path / "hf2")
    assert cli.main(["export-hf", "--ckpt", ck2, "--out", out2,
                     "--size", "tiny", "--config", ckpt + ".config.json"]) == 0
    assert all(t.dtype == torch.float32
               for t in H.read_state_dict(out2).values())


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_export_hf_rejects_layer_mismatch(tmp_path, which):
    params = init_whisper_params(TINY, torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_pytree(ckpt, params)
    bad = dataclasses.replace(TINY, **{f"{which}_layers": 1})
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(bad), fh)
    with pytest.raises(ValueError, match="config mismatch"):
        cli.main(["export-hf", "--ckpt", ckpt, "--out", str(tmp_path / "o")])


def test_export_hf_without_config_raises(tmp_path):
    params = init_whisper_params(TINY, torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_pytree(ckpt, params)
    with pytest.raises(FileNotFoundError, match="sidecar"):
        cli.main(["export-hf", "--ckpt", ckpt, "--out", str(tmp_path / "o")])


def test_verify_parity_whisper(tmp_path):
    """``verify-parity`` on an exported random Whisper: logits within the
    tolerance of transformers', and the transcription comparison report,
    as the JAX command reports it."""
    from audax_torch.data.audio_io import write_wav
    from audax_torch.symbolic.bpe import train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer
    bpe = train_bpe(["hello world how are you"] * 4, vocab_size=90)
    tok_dir = str(tmp_path / "tok")
    bpe.save(tok_dir)
    # the model's vocab is the tokenizer's, so every special id has a row
    cfg = dataclasses.replace(TINY,
                              vocab_size=WhisperTokenizer(bpe).vocab_size)
    params = init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_pytree(ckpt, params)
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh)
    hf_dir = str(tmp_path / "hf")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", hf_dir]) == 0
    audio = tmp_path / "wavs"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_wav(str(audio / f"c{i}.wav"),
                  (0.1 * rng.standard_normal(8000)).astype(np.float32),
                  16000)
        (audio / f"c{i}.txt").write_text("hello world")
    report = str(tmp_path / "report.json")
    assert cli.main(["verify-parity", "--hf-dir", hf_dir, "--audio-dir",
                     str(audio), "--tokenizer-dir", tok_dir,
                     "--max-tokens", "6", "--report", report,
                     "--device", "cpu"]) == 0
    rep = json.load(open(report))
    assert rep["logit_parity"] and rep["logit_max_abs_diff"] < TOL_LOGITS
    assert len(rep["clips"]) == 2
    assert {"file", "audax", "hf", "reference"} <= set(rep["clips"][0])
    assert {"cross_wer_audax_vs_hf", "wer_audax_vs_reference",
            "wer_hf_vs_reference"} <= set(rep)


@pytest.mark.parametrize("kind", ["qwen2", "moe"])
def test_verify_parity_causal_lm(tmp_path, kind):
    hf = _hf_lm(kind, seed=8)
    hf_dir = str(tmp_path / "hf")
    hf.save_pretrained(hf_dir)
    report = str(tmp_path / "rep.json")
    assert cli.main(["verify-parity", "--hf-dir", hf_dir, "--kind",
                     "causal-lm", "--report", report, "--device",
                     "cpu"]) == 0
    rep = json.load(open(report))
    assert rep["kind"] == "causal-lm" and rep["logit_parity"]
    assert rep["logit_max_abs_diff"] < TOL_LOGITS


def test_verify_parity_classifier_matches_jax_report(tmp_path, monkeypatch):
    """``--kind classifier`` on a raw UrbanSound8K-layout stand-in: the
    port's report has the JAX command's keys, clip counts and published
    figures (the accuracies differ: each package draws its own init)."""
    from audax_torch.data.synth import make_synthetic_urbansound
    root = make_synthetic_urbansound(str(tmp_path / "US8K"), per_fold=2)
    monkeypatch.chdir(tmp_path)
    reports = []
    for name, run in (("ours", lambda a: cli.main(["verify-parity"] + a
                                                  + ["--device", "cpu"])),
                      ("theirs", jax_cli._COMMANDS["verify-parity"])):
        path = str(tmp_path / f"{name}.json")
        assert run(["--hf-dir", "unused", "--kind", "classifier",
                    "--data-dir", root, "--variant", "v1", "--model", "cnn",
                    "--epochs", "1", "--batch-size", "8",
                    "--report", path]) == 0
        reports.append(json.load(open(path)))
    ours, theirs = reports
    assert ours.keys() == theirs.keys()
    for k in ("kind", "variant", "model", "train_clips",
              "published_accuracy"):
        assert ours[k] == theirs[k], k
    assert ours["train_clips"] == 16
    assert 0.0 <= ours["fold10_accuracy"] <= 1.0


def test_transformers_is_the_reference_only(monkeypatch, tmp_path):
    """Without transformers, ``verify-parity --kind whisper`` raises
    ImportError (it is the reference), while ``convert-hf`` and
    ``export-hf`` run."""
    import builtins
    real = builtins.__import__

    def no_hf(name, *a, **k):
        if name.split(".")[0] in ("transformers", "safetensors"):
            raise ImportError(f"no {name}")
        return real(name, *a, **k)
    params = init_whisper_params(TINY, torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_pytree(ckpt, params)
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(TINY), fh)
    monkeypatch.setattr(builtins, "__import__", no_hf)
    out = str(tmp_path / "hf")
    assert cli.main(["export-hf", "--ckpt", ckpt, "--out", out]) == 0
    assert cli.main(["convert-hf", "--hf-dir", out, "--out",
                     str(tmp_path / "back"), "--quantize", "int4"]) == 0
    with pytest.raises(ImportError):
        cli.main(["verify-parity", "--hf-dir", out, "--device", "cpu"])
    assert len(tree_leaves(load_pytree(str(tmp_path / "back")))) > 0
