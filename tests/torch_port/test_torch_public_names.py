"""The JAX package's public names the port carries last, against the JAX
package on the CPU: ``core/config.py:load_dotenv`` (and the command line
reading ``.env`` first), ``symbolic/tokenizer.py:VocabTokenizer`` and the
two-tower recipe's optimizer transforms ``train/optim.py:dual_lr`` and
``reduce_on_plateau``. (``ContinuousBatcher.warmup(all_buckets=)`` is held
in ``test_torch_continuous.py``.)

Tolerances: the dotenv parse, the environment and the tokenizer exact;
``dual_lr``'s updates over five steps within 1e-6 of optax's (atol, the
float32 rounding of an update near 1e-3); ``reduce_on_plateau``'s scales
exact (the same float32 arithmetic) and its scaled updates within 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audax.core import config as JC
from audax.symbolic.tokenizer import VocabTokenizer as JaxVocab
from audax.train import optim as JO
from audax_torch.core import config as C
from audax_torch.models.whisper import tree_leaves, tree_map
from audax_torch.symbolic.tokenizer import VocabTokenizer
from audax_torch.train import optim as O

DOTENV = ("# comment\nBATCH_SIZE=32\nNAME='quoted'\n  EPOCHS = 7 \n"
          "EMPTY=\nNO_EQUALS_LINE\nQUOTE=\"a b\"\nMIXED='x\"\n"
          "ALREADY=from-file\n")
KEYS = ("BATCH_SIZE", "NAME", "EPOCHS", "EMPTY", "QUOTE", "MIXED",
        "ALREADY")


@pytest.mark.parametrize("override", [False, True])
def test_load_dotenv_matches_jax(tmp_path, monkeypatch, override):
    """The same parse, the same environment afterwards (a variable already
    set kept unless ``override``), and ``from_env`` reading it; a missing
    file parses to nothing."""
    p = tmp_path / ".env"
    p.write_text(DOTENV)
    results = []
    for load in (JC.load_dotenv, C.load_dotenv):
        for k in KEYS:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("ALREADY", "from-env")
        parsed = load(str(p), override=override)
        results.append((parsed, {k: os.environ.get(k) for k in KEYS}))
    assert results[0] == results[1]
    parsed, env = results[1]
    assert parsed["BATCH_SIZE"] == "32" and parsed["NAME"] == "quoted"
    assert env["ALREADY"] == ("from-file" if override else "from-env")
    assert C.ClassifierTrainConfig.from_env().batch_size == 32
    assert C.load_dotenv(str(tmp_path / "missing")) == {} == \
        JC.load_dotenv(str(tmp_path / "missing"))


def test_cli_main_reads_dotenv(tmp_path, monkeypatch, capsys):
    """``cli.main`` reads ``.env`` from the working directory first, as
    JAX's does, before it looks at the command."""
    from audax_torch.cli import main as cli
    (tmp_path / ".env").write_text("AUDAX_TEST_DOTENV=seen\nEPOCHS=9\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("AUDAX_TEST_DOTENV", raising=False)
    monkeypatch.delenv("EPOCHS", raising=False)
    assert cli.main(["--help"]) == 0
    assert "bench-train" in capsys.readouterr().out
    assert os.environ["AUDAX_TEST_DOTENV"] == "seen"
    assert C.ClassifierTrainConfig.from_env().epochs == 9


def test_vocab_tokenizer_matches_jax(tmp_path):
    """Encode (an unknown token to ``<unk>``), decode with and without the
    specials, the special ids and length, custom specials, and save/load
    round trips read by the other package."""
    vocab = {"C4": 0, "D4": 1, "|": 2, "<s>": 3}
    toks = ["C4", "D4", "|", "X9", "<s>", "</s>", "<pad>"]
    for kw in ({}, dict(unk="?", pad="_", bos="<s>", eos="$")):
        j, t = JaxVocab(vocab, **kw), VocabTokenizer(vocab, **kw)
        assert t.vocab == j.vocab and len(t) == len(j)
        assert (t.pad_id, t.bos_id, t.eos_id) == (j.pad_id, j.bos_id,
                                                  j.eos_id)
        ids = t.encode_tokens(toks)
        assert ids == j.encode_tokens(toks)
        assert ids[3] == t.vocab[t.unk]
        for skip in (True, False):
            assert t.decode(ids + [99], skip_special=skip) == \
                j.decode(ids + [99], skip_special=skip)
        assert t.decode(np.asarray(ids)) == j.decode(ids)
        p, jp = str(tmp_path / "sub" / "ours.json"), str(tmp_path / "j.json")
        t.save(p)
        j.save(jp)
        assert open(p).read() == open(jp).read()
        # load takes the default specials (added where missing)
        back = VocabTokenizer.load(jp)
        assert back.vocab == JaxVocab.load(p).vocab
        assert set(t.vocab.items()) <= set(back.vocab.items())


# ------------------------------------------------------------ optimizers --
SHAPES = {"adapter": {"k": (8, 6), "b": (6,)},
          "lm": {"w": (5, 7), "frozen_w": (7, 3)}, "head": (4,)}


def _label(params):
    """adapter -> "adapter", head -> "adapter", lm/w -> "lm", the rest
    frozen (a callable, as the JAX two-tower passes)."""
    return {"adapter": {"k": "adapter", "b": "adapter"},
            "lm": {"w": "lm", "frozen_w": "frozen"}, "head": "adapter"}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)

    def one(shape):
        return (scale * r.standard_normal(shape)).astype(np.float32)
    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in SHAPES.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_dual_lr_matches_optax(grad_clip):
    """Five steps of per-group AdamW (adapter 1e-3, lm 2e-4) with a frozen
    group, the global-norm clip first (the gradients are large enough to
    clip): every update equals JAX's ``optax`` chain within 1e-6 and the
    frozen leaves' updates are zero."""
    lrs = {"adapter": 1e-3, "lm": 2e-4}
    jtx = JO.dual_lr(_label, lrs, grad_clip=grad_clip)
    tx = O.dual_lr(_label, lrs, grad_clip=grad_clip)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = tree_map(torch.from_numpy, _tree(0))
    js, ts = jtx.init(jp), tx.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=3.0)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = tx.update(tree_map(torch.from_numpy, g), ts, tp)
        want, got = _flat(ju), _flat(tree_map(lambda t: t.numpy(), tu))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {k}")
        assert not got["/lm/frozen_w"].any()
        jp = optax.apply_updates(jp, ju)
        O.apply_updates(tp, tu)
    assert {g: s.count for g, s in ts.groups.items()} == {"adapter": 5,
                                                          "lm": 5}


def test_dual_lr_rejects_an_unknown_label():
    with pytest.raises(ValueError, match="no rate"):
        O.dual_lr(lambda p: {"w": "other"}, {"lm": 1e-3}).init(
            {"w": torch.zeros(2)})


#: validation losses that improve, plateau for two calls (a reduction),
#: improve by less than rtol (no improvement), plateau again (a second
#: reduction), then keep falling to the floor of min_scale
PLATEAU_LOSSES = [3.0, 2.5, 2.5, 2.6, 2.4, 2.39999, 2.41, 2.5, 2.2, 2.2,
                  2.2, 2.2, 2.2, 2.2, 2.2, 2.2, 2.2, 2.2, 2.2, 2.2, 2.2,
                  2.2, 2.2]


@pytest.mark.parametrize("kw", [{}, dict(patience=1, factor=0.25,
                                        min_scale=0.1)],
                         ids=["jax_defaults", "floor"])
def test_reduce_on_plateau_matches_optax(kw):
    """The scale after each value of a loss sequence that plateaus twice
    (and, with a short patience, reaches the floor) equals optax's, and
    the updates are scaled by it."""
    jtx = JO.reduce_on_plateau(**kw)
    tx = O.reduce_on_plateau(**kw)
    params = {"w": np.ones(3, np.float32)}
    js, ts = jtx.init(params), tx.init(None)
    upd = {"w": np.array([1.0, -2.0, 0.5], np.float32)}
    scales = []
    for v in PLATEAU_LOSSES:
        ju, js = jtx.update(jax.tree.map(jnp.asarray, upd), js, value=v)
        tu, ts = tx.update(tree_map(torch.from_numpy, upd), ts, value=v)
        assert float(ts.scale) == float(js.scale)
        assert ts.plateau_count == int(js.plateau_count)
        assert int(js.cooldown_count) == 0 and int(js.count) == 0
        assert float(ts.best_value) == float(js.best_value)
        np.testing.assert_allclose(tree_leaves(tu)[0].numpy(),
                                   np.asarray(ju["w"]), atol=1e-7, rtol=0)
        scales.append(float(ts.scale))
    reductions = sum(b < a for a, b in zip(scales, scales[1:]))
    assert reductions >= 2, scales
