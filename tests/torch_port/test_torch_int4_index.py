"""Kernel K9 (``audax_torch/ops/int4_matmul.py``) with its stacked index as
a device tensor, on the CPU.

The TPU kernel (``audax/ops/int4_matmul.py:int4_matmul``) reads the index
of its stacked weight slice from the device (a scalar prefetch); the
mixture-of-experts decode step hands it the router's expert id. The port
takes ``layer`` as a host int or as a one-element integer tensor. Here:
the plain version with a tensor index against JAX's Pallas kernel in
interpret mode with a TRACED index (and against the host-int route on the
same slice, and a second index that selects another slice); the
large-M branch; the operand checks; and, on stand-in CUDA tensors, the
wrappers' C calls: a tensor index reaches both bodies as a pointer, with
its width and the stack's length, and nothing reads it on the host.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops import int4_matmul as J
from audax_torch.ops import int4_matmul as T
from audax_torch.ops import native


def _stack(seed, layers, k_dim, n):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((layers, k_dim, n)).astype(np.float32)
    jq, js = J.quantize_int4(jnp.asarray(w))
    return jq, js, torch.from_numpy(np.array(jq)), torch.from_numpy(
        np.array(js))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_tensor_index_matches_jax_traced_index(dtype):
    jq, js, q, s = _stack(0, 5, 256, 384)
    x = np.random.default_rng(1).standard_normal((3, 256)).astype(np.float32)
    kernel = jax.jit(lambda xx, li: J.int4_matmul(
        xx, jq, js, layer=li, backend="pallas", interpret=True))
    for layer in (0, 3, 4):
        ref = np.asarray(kernel(jnp.asarray(x), jnp.int32(layer)))
        idx = torch.tensor(layer, dtype=dtype)
        got = T.int4_matmul(torch.from_numpy(x), q, s, layer=idx)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)
        # the same bits as the host-int route, and a [1] index too
        torch.testing.assert_close(
            T.int4_matmul(torch.from_numpy(x), q, s, layer=layer), got,
            atol=0, rtol=0)
        torch.testing.assert_close(
            T.int4_matmul(torch.from_numpy(x), q, s, layer=idx.reshape(1)),
            got, atol=0, rtol=0)
    other = T.int4_matmul(torch.from_numpy(x), q, s,
                          layer=torch.tensor(1, dtype=dtype))
    assert not torch.equal(other, got)


def test_tensor_index_on_the_large_m_branch():
    jq, js, q, s = _stack(2, 3, 256, 128)
    x = np.random.default_rng(3).standard_normal((300, 256)).astype(
        np.float32)
    ref = np.asarray(J.int4_matmul(jnp.asarray(x), jq, js, layer=2,
                                   backend="xla"))
    got = T.int4_matmul_dequant(torch.from_numpy(x), q, s,
                                layer=torch.tensor(2))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_tensor_index_operand_checks():
    _, _, q, s = _stack(4, 2, 64, 32)
    x = torch.zeros(1, 64)
    for bad, match in ((torch.tensor([0, 1]), "one int32"),
                       (torch.tensor(0.0), "one int32")):
        with pytest.raises(ValueError, match=match):
            T.int4_matmul(x, q, s, layer=bad)
    with pytest.raises(ValueError, match="stacked"):
        T.int4_matmul(x, q[0], s[0], layer=torch.tensor(0))
    with pytest.raises(IndexError):
        T.int4_matmul(x, q, s, layer=torch.tensor(2))


class _OnCard:
    """A stand-in CUDA tensor: a CPU tensor that says it is on the card,
    for the wrappers' checks and C calls (the C entry is recorded, not
    run)."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)

    def __getitem__(self, i):
        return self._t[i]


@pytest.fixture
def c_calls(monkeypatch):
    """Record each C call of K9's two libraries as (entry, args)."""
    calls = []

    class Lib:
        def __getattr__(self, entry):
            if entry.endswith("_splits"):
                return lambda *a: 1
            return lambda *a: calls.append((entry, a)) or 0

    monkeypatch.setattr(native, "library", lambda name: Lib())

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    for fn in (T.int4_matmul_mma_cuda, T.int4_matmul_cuda):
        monkeypatch.setattr(fn, "launches", fn.launches)
    return calls


@pytest.mark.parametrize("k_dim,group,entry", [
    (256, 128, "int4_matmul_mma"), (320, 40, "int4_matmul")])
def test_a_tensor_index_reaches_the_kernel_as_a_pointer(monkeypatch, c_calls,
                                                        k_dim, group, entry):
    """Both bodies: the stack's base pointers, then the index's pointer, its
    width and the stack's length in the prototype's places; no ``int()``,
    ``item`` or ``tolist`` of any tensor on the way."""
    w = torch.randn(4, k_dim, 64)
    q, s = T.quantize_int4(w, group=group)
    idx = torch.tensor([7, 2], dtype=torch.int64)[1:]        # a view
    x = _OnCard(torch.zeros(8, k_dim))
    read = []
    for name in ("item", "tolist", "__int__", "__index__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _n=name, _o=orig:
                            (read.append(_n), _o(self, *a))[1])
    T.int4_matmul(x, _OnCard(q), _OnCard(s), layer=idx)
    monkeypatch.undo()
    assert read == []
    (got_entry, args), = c_calls
    assert got_entry == entry
    src = (native.CSRC / native.KERNEL_SOURCES[entry]).read_text()
    params = [p.split()[-1].lstrip("*") for p in re.search(
        rf"int {entry}\(([^)]*)\)", src)[1].split(",")]
    assert len(params) == len(native.SIGNATURES[entry][entry][0])
    got = dict(zip(params, args))
    assert got["packed"] == q.data_ptr() and got["scales"] == s.data_ptr()
    assert (got["sel"], got["sel_bytes"], got["count"]) == (
        idx.data_ptr(), 8, 4)
    assert got["group"] == group and got["k"] == k_dim


def test_a_host_int_keeps_the_slice_pointer(c_calls):
    q, s = T.quantize_int4(torch.randn(3, 256, 64))
    T.int4_matmul(_OnCard(torch.zeros(8, 256)), _OnCard(q), _OnCard(s),
                  layer=2)
    (_, args), = c_calls
    assert args[1] == q[2].data_ptr() and args[2] == s[2].data_ptr()
    assert args[9:12] == (None, 0, 0)
