"""K7 + K8, flash attention backward (``csrc/flash_bwd_sm90.cu`` in bf16:
dQ and dK/dV, two launches a call).

Per call: the five products the backward needs (S = QK^T again, dP, dV,
dK, dQ: 2.5 times the forward's two), against the tensor-core peak of the
inputs' type; bytes: q, k, v, o, dO and the log-sum-exp read once, dQ, dK,
dV written once.
"""

import importlib

_fwd = importlib.import_module("benchmark.rooflines.flash_fwd")

NAMES = ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
LAUNCHES_PER_CALL = 2
PATCHES = [("audax_torch.ops.attention", "flash_backward")]


def record(q, k, v, o, lse, do, *, causal=False, **_):
    return _fwd.record(q, k, v, causal=causal)


def least_seconds(records, peaks):
    total = 0.0
    for c in records:
        ops = 2.5 * _fwd.flops(c)
        qo = 3 * c["b"] * c["hq"] * c["tq"] * c["d"] * c["elt"]   # q, o, dO
        kv = 2 * c["b"] * c["hk"] * c["tk"] * c["d"] * c["elt"]
        grads = qo // 3 + kv                                     # dQ, dK, dV
        nbytes = qo + kv + grads + 4 * c["b"] * c["hq"] * c["tq"]
        total += max(ops / _fwd.peak(c, peaks),
                     nbytes / peaks["hbm_bytes_per_s"])
    return total
