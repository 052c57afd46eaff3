"""K3, decode attention over the layer-stacked float caches
(``csrc/decode_attention_sm90.cu``).

Per call: q [B, H, Tq, D] against layer ``layer`` of a cache [L, B, Hk,
S, D]. Row i of slot b attends the keys at positions <= pos[b] + i (all S
keys when pos is None). Bytes: the keys and values attended, q read and o
written once; operations: QK^T and PV over those keys. Per-slot positions
are device tensors: their sums are taken once, after the window.
"""

import torch

NAMES = ("decode_cluster_kernel",)
LAUNCHES_PER_CALL = 1
PATCHES = [("audax_torch.models.whisper", "decode_attention_stacked")]


def record(q, kv, layer, *, pos=None, **_):
    k = kv[0]
    return {"b": q.shape[0], "h": q.shape[1], "tq": q.shape[2],
            "d": q.shape[3], "hk": k.shape[2], "s": k.shape[3],
            "elt_q": q.element_size(), "elt_kv": k.element_size(),
            "pos": pos}


def _keys(records):
    """Keys attended by each call, summed over its rows."""
    out = [0] * len(records)
    vec = [i for i, c in enumerate(records) if isinstance(c["pos"],
                                                          torch.Tensor)]
    if vec:
        stacked = torch.stack([records[i]["pos"].long() for i in vec])
        c0 = records[vec[0]]
        rows = torch.arange(c0["tq"], device=stacked.device)
        per = (stacked[:, :, None] + rows + 1).clamp(0, c0["s"]).sum((1, 2))
        for i, n in zip(vec, per.tolist()):
            out[i] = int(n)
    for i, c in enumerate(records):
        if c["pos"] is None:
            out[i] = c["b"] * c["tq"] * c["s"]
        elif not isinstance(c["pos"], torch.Tensor):
            p = int(c["pos"])
            out[i] = c["b"] * sum(min(max(p + r + 1, 0), c["s"])
                                  for r in range(c["tq"]))
    return out


def least_seconds(records, peaks):
    total = 0.0
    for c, keys in zip(records, _keys(records)):
        per_key = c["hk"] * c["d"] * c["elt_kv"] * 2
        qo = 2 * c["b"] * c["h"] * c["tq"] * c["d"] * c["elt_q"]
        nbytes = keys * per_key + qo
        ops = 4.0 * c["h"] * c["d"] * keys
        total += max(ops / peaks["bf16_flops"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return total
