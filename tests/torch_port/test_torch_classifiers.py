"""Port classifiers, train step and fold-protocol loops vs the JAX package
on the CPU.

The flax variables are initialised in JAX and bridged into the port's
modules with ``classifier_from_numpy``; inputs come from a numpy seed.
Tolerances: logits 1e-4 (float32, summation order only), parameters after
one AdamW step 1e-5, loss history 1e-4; metrics are computed from equal
predictions, so they are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import ClassifierTrainConfig as JaxTrainConfig
from audax.core.config import CNNClassifierConfig as JaxCNNConfig
from audax.core.config import TransformerClassifierConfig as JaxTFConfig
from audax.eval import metrics as jax_metrics
from audax.models import classifiers as JC
from audax.train.loops import evaluate_classifier as jax_evaluate
from audax.train.loops import fit_classifier as jax_fit
from audax.train.optim import adamw as jax_adamw
from audax.train.steps import TrainState as JaxTrainState
from audax.train.steps import make_classifier_steps as jax_steps
from audax_torch.core.config import (ClassifierTrainConfig,
                                     CNNClassifierConfig,
                                     TransformerClassifierConfig)
from audax_torch.eval import metrics as port_metrics
from audax_torch.models import classifiers as PC
from audax_torch.models.bridge import classifier_from_numpy
from audax_torch.train.checkpoints import CheckpointManager
from audax_torch.train.loops import evaluate_classifier, fit_classifier
from audax_torch.train.optim import adamw
from audax_torch.train.steps import TrainState, make_classifier_steps

MELS, FRAMES, CLASSES = 24, 37, 4


def _pair(kind, dropout=0.1):
    """(flax model, port model, input shape) at tiny widths."""
    if kind == "cnn":
        kw = dict(channels=(16, 32), head_dims=(32,), dropout=dropout,
                  num_classes=CLASSES)
        return (JC.CNNClassifier(JaxCNNConfig(**kw)),
                PC.CNNClassifier(CNNClassifierConfig(**kw), n_mels=MELS),
                (FRAMES, MELS))
    if kind in ("cls", "mean"):
        kw = dict(dim=32, heads=2, layers=2, mlp_dim=64, dropout=dropout,
                  num_classes=CLASSES, pool=kind)
        return (JC.TransformerClassifier(JaxTFConfig(**kw), max_len=64),
                PC.TransformerClassifier(TransformerClassifierConfig(**kw),
                                         max_len=64, n_mels=MELS),
                (FRAMES, MELS))
    # 1999 samples: SAME pads 57 at stride 16, 28 low and 29 high
    return (JC.WaveformCNNClassifier(num_classes=CLASSES, dropout=dropout),
            PC.WaveformCNNClassifier(num_classes=CLASSES, dropout=dropout),
            (1999,))


KINDS = ["cnn", "cls", "mean", "waveform"]


def _init(jmodel, x, seed=0):
    key = jax.random.key(seed)
    v = jmodel.init({"params": key, "dropout": key}, jnp.asarray(x),
                    train=True)
    return jax.tree.map(np.asarray, v)


def _data(rng, n, shape):
    y = rng.integers(0, CLASSES, n)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    if len(shape) == 2:                  # class k lifts mel band k
        for i in range(n):
            x[i, :, y[i] * 4: y[i] * 4 + 4] += 1.5
    return {"x": x, "y": y.astype(np.int64)}


@pytest.mark.parametrize("kind", KINDS)
def test_eval_logits_match(kind, rng):
    jm, pm, shape = _pair(kind)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    v = _init(jm, x)
    if "batch_stats" in v:             # non-trivial running statistics
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            v["batch_stats"])
    classifier_from_numpy(v, pm)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    ours = pm(torch.from_numpy(x)).detach().numpy()
    assert ours.shape == ref.shape == (3, CLASSES)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_train_forward_and_batch_stats(kind, rng):
    """Train mode at dropout 0: batch statistics normalise, and the running
    statistics take the BIASED batch variance with momentum 0.99."""
    jm, pm, shape = _pair(kind, dropout=0.0)
    x = (2.0 * rng.standard_normal((4,) + shape) + 0.5).astype(np.float32)
    v = _init(jm, x)
    classifier_from_numpy(v, pm)
    ref, upd = jm.apply(v, jnp.asarray(x), train=True,
                        rngs={"dropout": jax.random.key(1)},
                        mutable=["batch_stats"])
    ours = pm(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4, rtol=0)
    stats = jax.tree_util.tree_leaves_with_path(upd.get("batch_stats", {}))
    assert (len(stats) > 0) == (kind in ("cnn", "waveform"))
    buffers = dict(pm.named_buffers())
    for path, leaf in stats:
        name = ".".join(p.key for p in path)
        np.testing.assert_allclose(buffers[name].numpy(), np.asarray(leaf),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_one_adamw_step_matches(kind, rng):
    jm, pm, shape = _pair(kind, dropout=0.0)
    data = _data(rng, 8, shape)
    v = _init(jm, data["x"])
    classifier_from_numpy(v, pm)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                  tx=jax_adamw(1e-3, 1e-4),
                                  batch_stats=v.get("batch_stats", {}))
    jtrain, _ = jax_steps(jm, donate=False)
    jstate, jm_out = jtrain(jstate, {k: jnp.asarray(a) for k, a in
                                     data.items()}, jax.random.key(2))
    train, _ = make_classifier_steps(pm)
    state = TrainState.create(pm, adamw(1e-3, 1e-4))
    state, m = train(state, {k: torch.from_numpy(a) for k, a in
                             data.items()})
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]),
                               rtol=1e-5)
    # the updated flax tree, bridged, must equal the port's own update
    want = {"params": jax.tree.map(np.asarray, jstate.params),
            "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    _, twin, _ = _pair(kind, dropout=0.0)
    classifier_from_numpy(want, twin)
    got = dict(pm.named_parameters())
    got.update(pm.named_buffers())
    for name, t in list(twin.named_parameters()) + list(twin.named_buffers()):
        if name.endswith(".key.bias"):
            continue                      # held below
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   t.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    # A key bias adds q.b to every score of a query's row, which the softmax
    # cancels: its gradient is zero up to rounding in both packages, and
    # Adam's first update (g / (|g| + 1e-8)) scales that rounding noise, so
    # the two updates there are noise. Hold the gradient to zero instead.
    keys = [n for n in got if n.endswith(".key.bias")]
    assert bool(keys) == (kind in ("cls", "mean"))
    if keys:
        classifier_from_numpy(v, pm)
        x = torch.from_numpy(data["x"])
        loss = torch.nn.functional.cross_entropy(
            pm(x, train=True), torch.from_numpy(data["y"]))
        params = dict(pm.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        scale = max(float(g.abs().max()) for g in grads.values())
        for n in keys:
            assert float(grads[n].abs().max()) <= 1e-6 * scale, n


@pytest.mark.parametrize("kind", ["cnn", "cls"])
def test_fit_classifier_loss_history(kind):
    rng = np.random.default_rng(3)
    jm, pm, shape = _pair(kind, dropout=0.0)
    train, ev = _data(rng, 48, shape), _data(rng, 21, shape)
    jcfg = JaxTrainConfig(batch_size=16, epochs=2, learning_rate=1e-3,
                          weight_decay=1e-4, seed=0)
    cfg = ClassifierTrainConfig(**jcfg.asdict())
    # the JAX loop initialises from key(cfg.seed) on the first train batch
    classifier_from_numpy(_init(jm, train["x"][:16], seed=jcfg.seed), pm)
    _, jhist = jax_fit(jm, train, ev, jcfg, num_classes=CLASSES)
    _, hist = fit_classifier(pm, train, ev, cfg, num_classes=CLASSES,
                             device="cpu")
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"],
                               atol=1e-4, rtol=0)
    for ours, ref in zip(hist["eval"], jhist["eval"]):
        np.testing.assert_array_equal(ours["confusion_matrix"],
                                      ref["confusion_matrix"])
        assert ours["f1_macro"] == ref["f1_macro"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], atol=1e-4)


def test_evaluate_padded_final_batch(rng):
    """37 rows at batch 16: the last batch carries 11 real rows and 5
    masked ones; both packages score exactly the 37."""
    jm, pm, shape = _pair("cnn")
    data = _data(rng, 37, shape)
    v = _init(jm, data["x"][:2])
    classifier_from_numpy(v, pm)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                  tx=jax_adamw(1e-3),
                                  batch_stats=v["batch_stats"])
    _, jeval = jax_steps(jm)
    jm_out, jpred = jax_evaluate(jeval, jstate, data, 16, CLASSES)
    _, peval = make_classifier_steps(pm)
    m, pred = evaluate_classifier(peval, TrainState.create(pm, adamw(1e-3)),
                                  data, 16, CLASSES)
    assert len(pred) == 37
    np.testing.assert_array_equal(pred, jpred)
    for key, ref in jm_out.items():
        if key == "loss":
            np.testing.assert_allclose(m[key], ref, atol=1e-5)
        else:
            np.testing.assert_array_equal(m[key], ref, err_msg=key)


def test_metrics_and_report_equal(rng):
    y_true = rng.integers(0, 10, 300)
    y_pred = np.where(rng.random(300) < 0.6, y_true, rng.integers(0, 10, 300))
    y_pred[y_pred == 7] = 3                  # a class never predicted
    ours = port_metrics.detailed_metrics(y_true, y_pred, 10)
    ref = jax_metrics.detailed_metrics(y_true, y_pred, 10)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    names = port_metrics.URBANSOUND8K_CLASSES
    assert names == jax_metrics.URBANSOUND8K_CLASSES
    assert (port_metrics.classification_report(y_true, y_pred, names)
            == jax_metrics.classification_report(y_true, y_pred, names))
    with pytest.raises(ValueError, match="outside"):
        port_metrics.confusion_matrix(np.array([-1]), np.array([0]), 10)


def test_one_device_knobs_raise(rng, tmp_path, mesh_of_one):
    """Neither knob raises any more: ``mesh=`` trains data-parallel (a mesh
    of one rank gives the run without a mesh, to the bit;
    ``test_torch_cli_mesh.py`` holds four ranks against JAX), and
    ``ckpt_manager=`` saves every epoch (``test_torch_checkpoints.py``
    holds the resume)."""
    _, pm, shape = _pair("cnn", dropout=0.0)
    data = _data(rng, 16, shape)
    cfg = ClassifierTrainConfig(batch_size=16, epochs=1)
    start = {k: v.clone() for k, v in pm.state_dict().items()}
    _, plain = fit_classifier(pm, data, None, cfg, device="cpu")
    pm.load_state_dict(start)
    _, meshed = fit_classifier(pm, data, None, cfg, mesh=mesh_of_one,
                               device="cpu")
    assert meshed["train_loss"] == plain["train_loss"]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    fit_classifier(pm, data, None, cfg, ckpt_manager=mgr, device="cpu")
    assert mgr.latest_step() == 0 and (tmp_path / "ck" / "0").is_dir()


def test_bridge_checks_shapes(rng):
    jm, _, shape = _pair("cls")
    v = _init(jm, rng.standard_normal((2,) + shape).astype(np.float32))
    short = PC.TransformerClassifier(
        TransformerClassifierConfig(dim=32, heads=2, layers=2, mlp_dim=64,
                                    num_classes=CLASSES),
        max_len=32, n_mels=MELS)
    with pytest.raises(ValueError, match="pos_embed"):
        classifier_from_numpy(v, short)
    with pytest.raises(ValueError, match="exceeds max_len"):
        short(torch.zeros(1, 40, MELS))
