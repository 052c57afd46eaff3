"""The comparisons that decide ``correct``, against ``whisper_ref``.

Served transcripts (greedy): the reference runs once over each sampled
request's prompt and served tokens, teacher-forced, in float32. At every
served position the gap is the reference's best allowed logit minus its
logit of the served token; a request's number is its widest gap, and the
run's is the widest over the sample. The control puts the reference in
the program's place in a lower precision and reads, at the same
positions, the gap of the token that precision puts first.

Fine-tune steps: the reference follows the program's first three steps
from the same weights and batches with plain AdamW (optax's chain order:
global-norm clip, Adam direction, + weight decay * p, times -lr on a
linear warm-up). Three numbers: each step's loss against the reference's
(relative gap, worst step); the first gradient as the optimizer got it
(per-leaf norms, the gap of the norms over the larger of the leaf's and
the median leaf's reference norm, worst leaf); the parameters' change
after three steps, by the same measure over the leaves whose reference
gradient is not nought to rounding (at least 1e-3 of the median leaf's).
The same three, prefixed ``late_``, for one step taken past the window
through the same call, which the reference follows from the program's
own state at that point (its float32 weights and Adam moments): the
gradient there is the one the first moment took in.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import whisper_ref as ref


def allowed_mask(vocab: int, suppressed: Sequence[int],
                 device) -> torch.Tensor:
    """True where the served engine may pick a token: every id outside the
    suppressed range [lo, hi) of the start/language/task specials."""
    m = torch.ones(vocab, dtype=torch.bool, device=device)
    m[suppressed[0]: suppressed[1]] = False
    return m


@torch.no_grad()
def served_gaps(params, cfg: dict, audio: torch.Tensor,
                served: List[List[int]], prompt: Sequence[int],
                low: ref.Lower = ref.FULL, control: bool = False,
                block: int = 4) -> List[dict]:
    """Per request, ``gap``: the widest gap of its served tokens. ``audio``
    [R, 480000] (zero-padded clips), ``served[r]`` its served tokens. With
    ``control``, also ``control_gap``: the widest gap of the tokens
    ``low`` puts first at the same positions, read against the float32
    reference."""
    heads = cfg["decoder_attention_heads"]
    dev = audio.device
    allow = allowed_mask(cfg["vocab_size"],
                         cfg["deployment"]["suppressed_range"], dev)
    n0 = len(prompt) - 1                   # the position predicting token 1
    out = []
    for i in range(0, audio.shape[0], block):
        mel = ref.log_mel(audio[i: i + block], cfg["num_mel_bins"])
        enc = ref.encode(params, heads, mel)
        enc_low = ref.encode(params, heads, mel, low) if control else None
        for j in range(mel.shape[0]):
            toks = list(prompt) + list(served[i + j])
            t = torch.tensor([toks], device=dev)
            tok = torch.tensor(served[i + j], device=dev)[:, None]
            rows = ref.decode(params, heads, t, enc[j: j + 1])[0][
                n0: len(toks) - 1].masked_fill(~allow, float("-inf"))
            best = rows.max(-1).values
            one = {"gap": float((best - rows.gather(1, tok)[:, 0]).max())}
            if control:
                lowl = ref.decode(params, heads, t, enc_low[j: j + 1],
                                  low)[0][n0: len(toks) - 1]
                pick = lowl.masked_fill(~allow, float("-inf")).argmax(-1)
                one["control_gap"] = float(
                    (best - rows.gather(1, pick[:, None])[:, 0]).max())
            out.append(one)
    return out


def norm_gap(prog: Dict[str, float], refn: Dict[str, float],
             keep: Sequence[str]) -> float:
    """Worst leaf of |prog - ref| / max(ref, median ref) over ``keep``."""
    vals = sorted(refn[k] for k in keep)
    med = vals[len(vals) // 2] if vals else 0.0
    worst = 0.0
    for k in keep:
        den = max(refn[k], med, 1e-30)
        worst = max(worst, abs(prog[k] - refn[k]) / den)
    return worst


def leaf_items(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaf_items(v, name)
        else:
            yield name, v


def clone_tree(tree):
    """A float32 copy of a tree of tensors."""
    return {k: (clone_tree(v) if isinstance(v, dict)
                else v.detach().float().clone()) for k, v in tree.items()}


def schedule(cfg: dict, count: int) -> float:
    dep = cfg["deployment"]
    warm, top = dep["warmup_steps"], dep["learning_rate"]
    if count < warm:
        return top * count / warm
    span = max(dep["max_steps"] - warm, 1)
    return top * max(0.0, 1.0 - (count - warm) / span)


def collate(rows: Sequence[Sequence[int]], start: int, multiple: int = 8):
    """Teacher forcing of label rows that open with the start token: the
    decoder reads [start] + the row's other tokens, and predicts them; both
    padded to a multiple of 8 positions (label -100 on padding)."""
    rows = [list(r[1:]) for r in rows]
    n = max(len(r) for r in rows) + 1
    n = -(-n // multiple) * multiple
    dec_in = torch.full((len(rows), n), start, dtype=torch.long)
    labels = torch.full((len(rows), n), -100, dtype=torch.long)
    for i, r in enumerate(rows):
        dec_in[i, 1: 1 + len(r)] = torch.tensor(r)
        labels[i, : len(r)] = torch.tensor(r)
    return dec_in, labels


def reference_steps(params: dict, cfg: dict, batches: list,
                    low: ref.Lower = ref.FULL, block: int = 4,
                    count0: int = 0, moments=None) -> dict:
    """Follow ``len(batches)`` fine-tune steps from ``params`` (float32
    leaves; copied). Each batch: (audio [B, N], label rows that open with
    the start token). ``count0`` steps have been taken before, leaving the
    Adam moments ``moments`` ((first, second), each {leaf name: tensor});
    none with ``count0`` 0. Returns losses, first-gradient leaf norms and
    the leaves' change norms."""
    dep = cfg["deployment"]
    heads = cfg["decoder_attention_heads"]
    params = clone_tree(params)
    leaves = dict(leaf_items(params))
    start = {k: v.detach().clone() for k, v in leaves.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    else:
        m, v2 = ({k: t[k].detach().float().clone() for k in leaves}
                 for t in moments)
    for v in leaves.values():
        v.requires_grad_(True)
    losses, grad_norms = [], None
    b1, b2, eps = dep["b1"], dep["b2"], dep["eps"]
    start_id = cfg["deployment"]["prompt"][0]
    for count, (audio, rows) in enumerate(batches, start=count0):
        dec_in, labels = (t.to(audio.device) for t in collate(rows, start_id))
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total, n = 0.0, 0
        for i in range(0, audio.shape[0], block):
            mel = ref.log_mel(audio[i: i + block], cfg["num_mel_bins"])
            s, c = ref.loss_sum(params, heads, mel, dec_in[i: i + block],
                                labels[i: i + block], low)
            g = torch.autograd.grad(s, list(leaves.values()))
            for k, gi in zip(leaves, g):
                grads[k] += gi
            total += float(s.detach())
            n += int(c)
        n = max(n, 1)
        for k in grads:
            grads[k] /= n
        losses.append(total / n)
        gnorm = torch.sqrt(sum((g.double() ** 2).sum()
                               for g in grads.values()))
        clip = min(1.0, dep["grad_clip"] / float(gnorm))
        with torch.no_grad():
            lr = schedule(cfg, count)
            t = count + 1
            for k, p in leaves.items():
                g = grads[k] * clip
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g * g, alpha=1 - b2)
                d = (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
                p.sub_(lr * (d + dep["weight_decay"] * p))
        if grad_norms is None:
            grad_norms = {k: float((grads[k] * clip).norm()) for k in grads}
    change = {k: float((leaves[k].detach() - start[k]).norm())
              for k in leaves}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def moved_leaves(refr: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    1e-3 of the median leaf's (a rule on the gradient, not on names)."""
    g = sorted(refr["grad_norms"].values())
    med = g[len(g) // 2]
    return [k for k, v in refr["grad_norms"].items() if v >= 1e-3 * med]


def train_numbers(prog: dict, refr: dict, prefix: str = "") -> dict:
    """The three compared numbers of a fine-tune run's steps."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       refr["losses"]))
    keys = list(refr["grad_norms"])
    moved = moved_leaves(refr)
    return {prefix + "loss_gap": loss_gap,
            prefix + "grad_norm_gap": norm_gap(prog["grad_norms"],
                                               refr["grad_norms"], keys),
            prefix + "update_norm_gap": norm_gap(prog["change"],
                                                 refr["change"], moved)}
