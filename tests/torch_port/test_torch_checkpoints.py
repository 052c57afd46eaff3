"""Port checkpoints (``audax_torch/train/checkpoints.py``) on the CPU: the
port's own format, the reader of the JAX package's orbax checkpoints, the
``CheckpointManager`` contract (retention of the latest steps, ``best/`` and
``best.json`` apart from it, subset restore, resume in a new manager) and
``fit_classifier(ckpt_manager=)``'s resume, bit-equal to a run that was
not stopped.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audax.train import checkpoints as JC
from audax_torch.core.config import ClassifierTrainConfig, CNNClassifierConfig
from audax_torch.models.classifiers import CNNClassifier
from audax_torch.train import checkpoints as PC
from audax_torch.train.loops import fit_classifier

REPO = Path(__file__).resolve().parents[2]


def _steps(mgr):
    """The step directories on disk, after every pending write."""
    mgr.wait()
    return sorted(int(n) for n in os.listdir(mgr.directory) if n.isdigit())


class Moments(NamedTuple):
    count: int
    mu: dict


def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "bf": torch.linspace(-1, 1, 5).to(torch.bfloat16),
            "i": torch.tensor([1, 2, 3], dtype=torch.int64),
            "nested": {"list": [torch.ones(2), 2.5, "text"], "none": None},
            "opt": Moments(3, {"m": torch.full((2,), 0.5)}),
            "np": np.arange(4, dtype=np.int32), "flag": True}


def test_roundtrip_plain_and_target(tmp_path):
    tree = _tree()
    PC.save_pytree(str(tmp_path / "t"), tree)
    assert sorted(os.listdir(tmp_path / "t")) == ["tree.json", "tree.pt"]
    raw = PC.load_pytree(str(tmp_path / "t"))
    assert raw["opt"] == {"count": 3, "mu": {"m": raw["opt"]["mu"]["m"]}}
    assert raw["nested"]["list"][1:] == [2.5, "text"]
    assert raw["nested"]["none"] is None and raw["flag"] is True
    assert raw["bf"].dtype == torch.bfloat16
    back = PC.load_pytree(str(tmp_path / "t"), tree)
    assert isinstance(back["opt"], Moments) and back["opt"].count == 3
    for key in ("w", "bf", "i"):
        assert back[key].dtype == tree[key].dtype
        assert torch.equal(back[key], tree[key])
    np.testing.assert_array_equal(back["np"], tree["np"])
    with pytest.raises(FileNotFoundError):
        PC.load_pytree(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="shape"):
        PC.load_pytree(str(tmp_path / "t"), {"w": torch.zeros(2)})


def test_async_save_snapshots_at_call(tmp_path):
    t = torch.zeros(1000)
    pending = PC.save_pytree(str(tmp_path / "a"), {"t": t}, block=False)
    t += 1                                  # after the snapshot
    pending.wait_until_finished()
    assert not PC.load_pytree(str(tmp_path / "a"))["t"].any()


def _jax_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.int32(7), "d": jnp.ones((4,), jnp.bfloat16)},
            "s": 3, "lst": [jnp.zeros(2), jnp.full((3,), 2.0)]}


def _same(raw, ref):
    np.testing.assert_array_equal(raw["a"].numpy(), np.asarray(ref["a"]))
    assert int(raw["b"]["c"]) == 7 and raw["s"] == 3
    assert raw["b"]["d"].dtype == torch.bfloat16
    assert torch.equal(raw["b"]["d"], torch.ones(4, dtype=torch.bfloat16))
    assert [t.tolist() for t in raw["lst"]] == [[0.0, 0.0], [2.0] * 3]


def test_reads_jax_orbax_pytree(tmp_path):
    JC.save_pytree(str(tmp_path / "jax"), _jax_tree())
    _same(PC.load_pytree(str(tmp_path / "jax")), _jax_tree())
    # in a process of its own: no jax, orbax or audax module is loaded
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from audax_torch.train.checkpoints import load_pytree\n"
            f"t = load_pytree({str(tmp_path / 'jax')!r})\n"
            "assert t['a'].shape == (2, 3) and t['s'] == 3\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'orbax', 'flax', 'audax'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_reads_jax_manager_step(tmp_path):
    tx = optax.adamw(1e-3)
    p = {"w": jnp.ones((2, 2))}
    mgr = JC.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    for s in range(3):
        mgr.save(s, {"params": p, "opt_state": tx.init(p),
                     "step": jnp.int32(s)}, metrics={"val_loss": 1.0 / (s + 1)})
    mgr.close()
    raw = PC.load_pytree(str(tmp_path / "m" / "2"))
    assert int(raw["step"]) == 2 and raw["params"]["w"].shape == (2, 2)
    assert isinstance(raw["opt_state"], list)
    assert int(raw["opt_state"][0]["count"]) == 0
    # the port's manager resumes from the JAX manager's latest step
    port = PC.CheckpointManager(str(tmp_path / "m"))
    assert port.latest_step() == 2
    got = port.restore({"params": {"w": torch.zeros(2, 2)}})
    assert torch.equal(got["params"]["w"], torch.ones(2, 2))


def test_orbax_reader_needs_tensorstore(tmp_path, monkeypatch):
    JC.save_pytree(str(tmp_path / "jax"), {"a": jnp.zeros(2)})
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        PC.load_pytree(str(tmp_path / "jax"))


def test_manager_retention_best_and_subset(tmp_path):
    d = tmp_path / "run"
    mgr = PC.CheckpointManager(str(d), max_to_keep=2,
                               config={"lr": 1e-3})
    states = {s: {"params": {"w": torch.full((3,), float(s))},
                  "opt": {"m": torch.full((3,), -float(s))}}
              for s in range(5)}
    # val_loss worsens after step 1: retention still keeps the LATEST two
    for s, v in zip(range(5), [3.0, 1.0, 2.0, 4.0, 5.0]):
        mgr.save(s, states[s], metrics={"val_loss": v, "acc": 0.5})
    assert _steps(mgr) == [3, 4] and mgr.latest_step() == 4
    assert mgr.best_step() == 1
    rec = json.loads((d / "best.json").read_text())
    assert rec == {"step": 1, "value": 1.0, "metric": "val_loss"}
    assert json.loads((d / "config.json").read_text()) == {"lr": 1e-3}
    best = mgr.restore_best(states[0])
    assert torch.equal(best["params"]["w"], torch.full((3,), 1.0))
    sub = mgr.restore({"params": states[0]["params"]})
    assert set(sub) == {"params"}
    assert torch.equal(sub["params"]["w"], torch.full((3,), 4.0))
    assert torch.equal(mgr.restore(states[0], step=3)["opt"]["m"],
                       torch.full((3,), -3.0))
    mgr.close()
    again = PC.CheckpointManager(str(d), max_to_keep=2)
    assert again.latest_step() == 4 and again.best_step() == 1
    with pytest.raises(FileNotFoundError):
        PC.CheckpointManager(str(tmp_path / "empty")).restore(states[0])


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 37, 24)).astype(np.float32),
            "y": rng.integers(0, 4, n)}


def _model():
    torch.manual_seed(0)
    return CNNClassifier(CNNClassifierConfig(channels=(8, 16),
                                             head_dims=(16,), dropout=0.3,
                                             num_classes=4), n_mels=24)


def test_fit_classifier_resumes_bit_exact(tmp_path):
    cfg = ClassifierTrainConfig(batch_size=8, epochs=3, learning_rate=1e-3)
    train, ev = _data(), _data(8, seed=1)
    straight = _model()
    _, hist = fit_classifier(straight, train, ev, cfg, num_classes=4,
                             device="cpu")
    stopped = _model()
    mgr = PC.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    fit_classifier(stopped, train, ev, ClassifierTrainConfig(
        batch_size=8, epochs=1, learning_rate=1e-3), num_classes=4,
        ckpt_manager=mgr, device="cpu")
    assert _steps(mgr) == [0]
    resumed = _model()                      # a fresh process's model
    state, rhist = fit_classifier(resumed, train, ev, cfg, num_classes=4,
                                  ckpt_manager=PC.CheckpointManager(
                                      str(tmp_path / "ck"), max_to_keep=2),
                                  device="cpu")
    assert rhist["train_loss"] == hist["train_loss"][1:]
    assert state.step == 3 * 3
    for (name, a), b in zip(straight.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name
    assert _steps(PC.CheckpointManager(str(tmp_path / "ck"))) == [1, 2]
