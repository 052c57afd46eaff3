"""K2, flash attention forward (``csrc/flash_fwd_sm90.cu`` in bf16).

Per call: the products QK^T and PV (2 * 2 * B * Hq * D per attended pair;
a causal square attends Tq (Tq + 1) / 2 pairs), against the tensor-core
peak of the inputs' type; bytes: q, k, v read once, o and the float32
log-sum-exp written once.
"""

NAMES = ("flash_fwd_sm90_kernel",)
LAUNCHES_PER_CALL = 1
PATCHES = [("audax_torch.ops.attention", "flash_forward")]


def record(q, k, v, *, causal=False, **_):
    return {"b": q.shape[0], "hq": q.shape[1], "tq": q.shape[2],
            "d": q.shape[3], "hk": k.shape[1], "tk": k.shape[2],
            "causal": bool(causal), "elt": q.element_size()}


def pairs(c):
    return c["tq"] * (c["tq"] + 1) // 2 if c["causal"] else c["tq"] * c["tk"]


def flops(c):
    return 4.0 * c["b"] * c["hq"] * c["d"] * pairs(c)


def nbytes(c):
    qo = 2 * c["b"] * c["hq"] * c["tq"] * c["d"] * c["elt"]
    kv = 2 * c["b"] * c["hk"] * c["tk"] * c["d"] * c["elt"]
    return qo + kv + 4 * c["b"] * c["hq"] * c["tq"]


def peak(c, peaks):
    return peaks["bf16_flops"] if c["elt"] == 2 else peaks["tf32_flops"] / 3


def least_seconds(records, peaks):
    return sum(max(flops(c) / peak(c, peaks),
                   nbytes(c) / peaks["hbm_bytes_per_s"]) for c in records)
