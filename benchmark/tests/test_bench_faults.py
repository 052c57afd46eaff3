"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip (the CPU runs the kernels'
plain versions at a tiny size) and plants one fault that a cell can have:
a step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, a served token altered where it is
produced. (One chip: no exchange between chips to leave out.)"""

import pytest

import tiny

SERVING = ["turbo-speech-backlog"]


@pytest.mark.parametrize("cell", SERVING)
def test_served_token_altered(cell, monkeypatch):
    from audax_torch.infer import continuous

    harvest = continuous._SlotEngine._harvest

    def altered(self):
        out = harvest(self)
        for r in out:
            if r.tokens:
                r.tokens[len(r.tokens) // 2] = (r.tokens[len(r.tokens) // 2]
                                                + 7) % 50257
        return out

    monkeypatch.setattr(continuous._SlotEngine, "_harvest", altered)
    res = tiny.run(cell, seconds=2.0)
    assert res["correct"] is False
    gap = res["checks"]["served_gap"]
    assert gap["value"] > gap["limit"]


def after_setup(monkeypatch, plant):
    """Plant a fault once set-up is over, so that it breaks the window."""
    from benchmark.lib import harness
    done = harness.Harness.setup_done

    def setup_done(self):
        done(self)
        plant()

    monkeypatch.setattr(harness.Harness, "setup_done", setup_done)


@pytest.mark.parametrize("cell", SERVING)
def test_decode_step_leaves_state_unchanged(cell, monkeypatch):
    from audax_torch.infer import continuous
    after_setup(monkeypatch, lambda: monkeypatch.setattr(
        continuous, "_advance", lambda *a, **k: None))
    res = tiny.run(cell, seconds=1.5)
    assert res["correct"] is False
    # nothing comes back: the backlog completes nothing to compare
    assert res["checks"]["served_gap"]["value"] is None


def test_train_step_leaves_state_unchanged(monkeypatch):
    from audax_torch.train import seq2seq
    monkeypatch.setattr(seq2seq, "apply_updates", lambda *a, **k: None)
    res = tiny.run("small-finetune-bf16", seconds=1.0)
    assert res["correct"] is False
    assert res["checks"]["update_norm_gap"]["value"] > 0.99
    assert res["checks"]["late_update_norm_gap"]["value"] > 0.99


def test_train_half_the_batch_left_out(monkeypatch):
    from audax_torch.train import seq2seq
    loss = seq2seq.seq2seq_loss

    def half(logits, labels):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n])

    monkeypatch.setattr(seq2seq, "seq2seq_loss", half)
    res = tiny.run("small-finetune-bf16", seconds=1.0)
    assert res["correct"] is False
    checks = res["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("loss_gap", "grad_norm_gap"))
