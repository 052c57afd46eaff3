"""The mixture-of-experts FFN at decode batch sizes: port of the four JAX
probes ``tools/moe_decode_probe.py``, ``moe_decode_probe2.py``,
``moe_decode_probe3.py`` and ``moe_decode_probe4.py`` as one tool.

The question the four ask: at decode (n tokens, n k selected slots, n k
<< E) both impls of ``models/causal_lm.py:_moe_block`` touch every
expert's weights, while the least a step must read is the selected
experts' bytes. The arms, by the JAX probe that measured them:

  ragged       (probes 1-4) sort the n k slots by expert, each expert's
               products over its rows (``causal_lm._ragged``), the k slots
               weighted back: the MoE block's ``ragged`` impl
  dense        (probes 1, 3) every expert on every token, combined by the
               [n, E] router-weight matrix: the ``dense`` impl
  gather       (probe 1) ``w[idx]`` -> [n, k, d, f] copies of the selected
               experts, then small einsums
  slice_scan   (probes 2, 3) the n k slots one after the other, each
               reading one expert (``index_select``): the MoE block's
               ``_moe_selected_scan`` over float experts
  k_slice      (probe 2's k-batched slice) per token, its k experts
               selected at once ([k, d, f]) and one batched product each
  int8_ragged  (probe 4) int8 experts cast whole to the activation dtype,
               then ragged (the ``ragged`` impl's int8 path)
  int8_scan    (probe 4) ``_moe_selected_scan`` over int8 experts
  int4_scan    (this port's decode path) ``_moe_selected_scan`` over int4
               experts: kernel K9 three times a slot with the expert id as
               a device tensor (``ops/int4_matmul.py``)

Shapes: a Qwen3-30B-A3B layer (d 2048, E 128, k 8, f 768), bf16, n in
{1, 4} on the card; d 64, E 8, k 2, f 48 at n in {1, 2} on the CPU (the
plain versions; those times say nothing of the card). Every arm is held
against ``ragged`` on the same weights -- the quantized arms against
``ragged`` on their dequantized weights -- within 2e-2 of its largest
output. On the card each arm is slope-timed in CUDA graphs
(``utils/profiling.slope_timed``) except the two ragged arms, whose group
sizes are read on the host once a call: they are slope-timed eagerly
between CUDA events (``slope_timed_eager``, host issue included). Each
row sits beside its floor: the bytes of the distinct experts the n tokens
selected (and their scales), read once from HBM at 3.35 TB/s; ``dense``
reads every expert.

    python -m audax_torch.tools.moe_decode_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audax_torch.core.runtime import resolve_device
from audax_torch.models.causal_lm import (CausalLMConfig, _moe_experts,
                                          _moe_selected_scan)
from audax_torch.models.quantize import quantize_matrix
from audax_torch.ops.int4_matmul import dequantize_int4, quantize_int4
from audax_torch.tools import cli, report
from audax_torch.utils.profiling import (H100_HBM_BPS, slope_timed,
                                         slope_timed_eager)

__all__ = ["SHAPES", "ARMS", "ragged", "dense", "gather", "slice_scan",
           "k_slice", "main"]

#: (d, E, k, f, decode batch sizes) on the card and on the CPU
SHAPES = {"cuda": (2048, 128, 8, 768, (1, 4)),
          "cpu": (64, 8, 2, 48, (1, 2))}
#: the largest |arm - ragged| allowed, relative to max |ragged|
TOL = 2e-2
_MATS = ("gate", "up", "down")


def ragged(h, w, idx, wgt):
    """The MoE block's ``ragged`` impl over expert weights ``w`` ({gate, up,
    down} of float or int8 leaves)."""
    return _moe_experts(w, h, idx, wgt, "ragged")


def dense(h, w, idx, wgt):
    """The MoE block's ``dense`` impl: every expert on every token."""
    return _moe_experts(w, h, idx, wgt, "dense")


def gather(h, w, idx, wgt):
    """Copies of the selected experts [n, k, d, f], then small einsums."""
    gk, uk, dk = (w[m]["kernel"][idx] for m in _MATS)
    g = torch.einsum("nd,nkdf->nkf", h, gk)
    u = torch.einsum("nd,nkdf->nkf", h, uk)
    o = torch.einsum("nkf,nkfd->nkd", F.silu(g) * u, dk)
    return torch.einsum("nkd,nk->nd", o, wgt)


def k_slice(h, w, idx, wgt):
    """Per token, its k experts selected at once and one batched product
    per matrix."""
    n, d = h.shape
    k = idx.shape[1]
    acc = torch.zeros_like(h)
    for t in range(n):
        e = idx[t]
        x = h[t: t + 1].expand(k, 1, d)
        g, u, dn = (w[m]["kernel"].index_select(0, e) for m in _MATS)
        y = torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), dn)
        acc[t] = (y[:, 0] * wgt[t, :, None].to(y.dtype)).sum(0)
    return acc


def slice_scan(h, w, idx, wgt):
    """The MoE block's ``_moe_selected_scan`` (float, int8 or int4
    experts)."""
    return _moe_selected_scan(
        w, CausalLMConfig(experts_per_tok=idx.shape[1]), h, idx, wgt)


def _weights(dev, d, e, f, gen):
    """bf16 expert weights {gate, up, down} and their int8 and int4
    quantizations (one scale per (expert, channel); groups of 128 rows, or
    ``fit_group``'s at a small d)."""
    w = {"gate": torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5,
         "up": torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5,
         "down": torch.randn(e, f, d, generator=gen, device=dev) * f ** -0.5}
    bf = {m: {"kernel": t.bfloat16()} for m, t in w.items()}
    q8, q4 = {}, {}
    for m, t in w.items():
        q, s = quantize_matrix(t, axis=-2)
        q8[m] = {"kernel_q": q, "kernel_scale": s}
        q, s = quantize_int4(t)
        q4[m] = {"kernel_q4": q, "kernel_scale4": s}
    return bf, q8, q4


def _dequantized(q8, q4):
    """Float weights of the int8 and int4 experts, bf16 (the reference
    ragged arm of each quantized arm)."""
    d8 = {m: {"kernel": (p["kernel_q"].float() * p["kernel_scale"][:, None]
                         ).bfloat16()} for m, p in q8.items()}
    d4 = {m: {"kernel": dequantize_int4(p["kernel_q4"], p["kernel_scale4"]
                                        ).bfloat16()}
          for m, p in q4.items()}
    return d8, d4


def _expert_bytes(w, experts) -> int:
    """Bytes of ``experts`` (a count) of weights ``w``, scales included."""
    total = 0
    for p in w.values():
        for t in p.values():
            total += t.numel() // t.shape[0] * t.element_size() * experts
    return total


#: arm -> (function, weights: "bf16" / "int8" / "int4", reference weights,
#: timed in graphs)
ARMS = {"ragged": (ragged, "bf16", "bf16", False),
        "dense": (dense, "bf16", "bf16", True),
        "gather": (gather, "bf16", "bf16", True),
        "slice_scan": (slice_scan, "bf16", "bf16", True),
        "k_slice": (k_slice, "bf16", "bf16", True),
        "int8_ragged": (ragged, "int8", "deq8", False),
        "int8_scan": (slice_scan, "int8", "deq8", True),
        "int4_scan": (slice_scan, "int4", "deq4", True)}


def main(device=None, out=None) -> dict:
    """Every arm at each decode batch size: µs beside its floor, its error
    against ``ragged``; the fastest arm at each n is the verdict."""
    dev = resolve_device(device)
    d, e, k, f, batches = SHAPES["cuda" if dev.type == "cuda" else "cpu"]
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, q8, q4 = _weights(dev, d, e, f, gen)
    d8, d4 = _dequantized(q8, q4)
    weights = {"bf16": bf, "int8": q8, "int4": q4, "deq8": d8, "deq4": d4}
    cuda = dev.type == "cuda"
    iters, repeats = ((5, 25), 3) if cuda else ((2, 12), 2)
    rows, fastest = [], {}
    for n in batches:
        h = torch.randn(n, d, generator=gen, device=dev).bfloat16()
        idx = torch.stack([torch.randperm(e, generator=gen, device=dev)[:k]
                           for _ in range(n)])
        wgt = torch.softmax(torch.randn(n, k, generator=gen, device=dev),
                            -1).bfloat16()
        distinct = int(torch.unique(idx).numel())
        refs = {name: ragged(h, weights[name], idx, wgt).float()
                for name in ("bf16", "deq8", "deq4")}
        for arm, (call, wname, rname, graphs) in ARMS.items():
            w = weights[wname]
            got = call(h, w, idx, wgt).float()
            ref = refs[rname]
            err = float((got - ref).abs().max() / ref.abs().max())
            if not err <= TOL:
                raise AssertionError(f"moe_decode_probe {arm} n={n}: "
                                     f"{err:.3e} off ragged (> {TOL})")
            timer = slope_timed if graphs else slope_timed_eager
            sec = timer(lambda: call(h, w, idx, wgt), (), iters=iters,
                        repeats=repeats, device=dev if cuda else None)
            nbytes = _expert_bytes(w, e if arm == "dense" else distinct)
            rows.append({"arm": arm, "n": n, "shape": [d, e, k, f],
                         "us": 1e6 * sec,
                         "timing": ("CUDA graphs" if graphs else "eager, "
                                    "CUDA events") if cuda else "host",
                         "bytes": nbytes,
                         "floor_us": 1e6 * nbytes / H100_HBM_BPS,
                         "max_rel_err": err})
        at_n = [r for r in rows if r["n"] == n]
        fastest[n] = min(at_n, key=lambda r: r["us"])["arm"]
    verdict = "; ".join(f"n={n}: {a} fastest" for n, a in fastest.items())
    return report("moe_decode_probe", dev, rows, verdict, out,
                  shape=dict(d=d, experts=e, top_k=k, ffn=f))


if __name__ == "__main__":
    cli(main)
