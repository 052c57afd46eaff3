"""Decode attention over more query rows than one kernel launch takes.

K3/K6 take at most 16 query rows per launch; a longer span (a speculative
prefill: ``<|startofprev|>`` + 64 context tokens + the 4-token SOT
sequence = 69 rows) is launched in chunks of 16 by
``ops/attention.py:_decode_rows``, the chunk starting at row r0 run at
``pos + r0``. On the CPU the helper drives the plain version, chunk by
chunk, and is held against one unchunked plain call: float32 within 1e-6
(the chunks change only the batch of each einsum, not what a row sums).
Scalar and per-slot ``pos``, no ``pos`` (every key), the float and the
int8 cache, stacked (K3) and unstacked (K6).
"""

import math

import numpy as np
import pytest
import torch

from audax_torch.models.whisper import quantize_kv
from audax_torch.ops import attention as att


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _pos(kind, b):
    if kind == "scalar":
        return 7
    if kind == "per_slot":
        return torch.tensor([0, 30, 90][:b], dtype=torch.int32)
    return None


@pytest.mark.parametrize("tq", [40, 69])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot", "none"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_stacked_chunks_match_one_plain_call(tq, pos_kind, quant):
    rng = np.random.default_rng(tq)
    L, b, h, hkv, s_len, d = 2, 3, 4, 2, 160, 16
    q = _randn(rng, b, h, tq, d)
    k, v = _randn(rng, L, b, hkv, s_len, d), _randn(rng, L, b, hkv, s_len, d)
    kv = tuple(quantize_kv(k, v)) if quant else (k, v)
    plain = (att.decode_attention_stacked_int8_plain if quant
             else att.decode_attention_stacked_plain)
    pos = _pos(pos_kind, b)
    ref = plain(q, kv, 1, pos=pos)
    seen = []

    def launch(rows, at):
        seen.append((rows.shape[2], at))
        assert rows.is_contiguous()
        return plain(rows, kv, 1, pos=at)

    got = att._decode_rows(launch, q, pos)
    assert [n for n, _ in seen] == [16] * (tq // 16) + [tq % 16]
    assert len(seen) == math.ceil(tq / 16)
    for i, (_, at) in enumerate(seen):
        if pos is None:
            assert at is None
        else:
            np.testing.assert_array_equal(np.asarray(at), np.asarray(pos)
                                          + 16 * i)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_unstacked_chunks_match_one_plain_call(quant):
    """K6's cache [B, Hkv, S, D] at the speculative prefill's 69 rows."""
    rng = np.random.default_rng(5)
    b, h, s_len, d, tq = 2, 4, 96, 16, 69
    q = _randn(rng, b, h, tq, d)
    k, v = _randn(rng, b, h, s_len, d), _randn(rng, b, h, s_len, d)
    kv = tuple(quantize_kv(k, v)) if quant else (k, v)
    pos = torch.tensor([3, 20], dtype=torch.int32)
    ref = att.decode_attention_plain(q, kv, pos=pos)
    got = att._decode_rows(
        lambda rows, at: att.decode_attention_plain(rows, kv, pos=at), q, pos)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_up_to_sixteen_rows_is_one_launch():
    q = torch.zeros(1, 2, 16, 16)
    calls = []
    att._decode_rows(lambda rows, at: calls.append((rows, at)) or rows, q, 5)
    assert len(calls) == 1 and calls[0][0] is q and calls[0][1] == 5


def test_cuda_wrappers_refuse_cpu_tensors_of_any_length():
    q = torch.zeros(1, 2, 40, 16)
    k = torch.zeros(1, 1, 2, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        att.decode_attention_stacked_cuda(q, (k, k), 0, pos=3)
    with pytest.raises(ValueError, match="CUDA"):
        att.decode_attention_cuda(q, (k[0], k[0]), pos=3)
