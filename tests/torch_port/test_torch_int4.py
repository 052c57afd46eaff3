"""Port int4 weight-only matmul (kernel K9's plain side) vs the JAX package.

``fit_group``, ``quantize_int4`` and ``dequantize_int4`` must be exact:
the packed bytes are bit-identical to JAX's, so int4 trees cross the bridge
byte for byte. ``int4_matmul`` on CPU tensors (its plain version) is held
against the JAX Pallas kernel in interpret mode at 1e-5 * max|ref| + 1e-6
in float32 (the two sum the same products in another order), and its
large-M path against JAX's ``backend="xla"`` dequantize-then-matmul.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops import int4_matmul as J
from audax_torch.ops import int4_matmul as T


def _tol(ref):
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.mark.parametrize("k_dim,group", [(256, 128), (160, 128), (1280, 128),
                                         (5120, 128), (96, 64), (30, 128)])
def test_fit_group_matches_jax(k_dim, group):
    assert T.fit_group(k_dim, group) == J.fit_group(k_dim, group)


def test_fit_group_refuses_odd_k():
    with pytest.raises(ValueError, match="even"):
        T.fit_group(161)


@pytest.mark.parametrize("shape", [(256, 384), (160, 256), (2, 512, 100)],
                         ids=["2d", "group80", "stacked"])
def test_quantize_int4_bit_identical(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3, :] = 0.0                       # an all-zero row hits the floor
    jq, js = J.quantize_int4(jnp.asarray(w))
    q, s = T.quantize_int4(torch.from_numpy(w))
    assert q.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        T.dequantize_int4(q, s).numpy(),
        np.asarray(J.dequantize_int4(jq, js)))


@pytest.mark.parametrize("k_dim,n", [(256, 384), (160, 256), (512, 1000)],
                         ids=["256x384", "group80", "ragged_n"])
@pytest.mark.parametrize("m", [1, 8, 13])
def test_int4_matmul_plain_matches_pallas(rng, m, k_dim, n):
    w = rng.standard_normal((k_dim, n)).astype(np.float32)
    x = rng.standard_normal((m, k_dim)).astype(np.float32)
    jq, js = J.quantize_int4(jnp.asarray(w))
    ref = np.asarray(J.int4_matmul(jnp.asarray(x), jq, js, backend="pallas",
                                   interpret=True))
    before = T.int4_matmul_plain.launches
    got = T.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)))
    assert T.int4_matmul_plain.launches == before + 1
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref), rtol=0)


def test_int4_matmul_stacked_layer_select(rng):
    w = rng.standard_normal((3, 256, 384)).astype(np.float32)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)   # leading dims
    jq, js = J.quantize_int4(jnp.asarray(w))
    q, s = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    for layer in range(3):
        ref = np.asarray(J.int4_matmul(jnp.asarray(x), jq, js, layer=layer,
                                       backend="pallas", interpret=True))
        got = T.int4_matmul(torch.from_numpy(x), q, s, layer=layer)
        assert got.shape == (2, 4, 384)
        np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref), rtol=0)
        # the layer view is the same tensor as indexing the stack by hand
        torch.testing.assert_close(T.int4_matmul(torch.from_numpy(x),
                                                 q[layer], s[layer]), got)
    with pytest.raises(ValueError, match="layer index"):
        T.int4_matmul(torch.from_numpy(x), q, s)


def test_int4_matmul_bf16_activations(rng):
    """bfloat16 x: JAX's kernel takes bf16 products with float32 sums; the
    plain version a float32 product of the bf16 values. Both round once to
    bf16 at the end, so they agree to a bf16 step of the output."""
    w = rng.standard_normal((256, 384)).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    jq, js = J.quantize_int4(jnp.asarray(w))
    ref = np.asarray(J.int4_matmul(jnp.asarray(xb.float().numpy(),
                                               jnp.bfloat16), jq, js,
                                   backend="pallas", interpret=True)
                     ).astype(np.float32)
    got = T.int4_matmul(xb, torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=8e-3 * float(np.abs(ref).max()), rtol=0)


def test_int4_matmul_large_m_matches_xla(rng):
    """More than 256 rows: the JAX function dequantizes and calls XLA; the
    port's CPU path (plain) computes the same product."""
    w = rng.standard_normal((2, 256, 384)).astype(np.float32)
    x = rng.standard_normal((300, 256)).astype(np.float32)
    jq, js = J.quantize_int4(jnp.asarray(w))
    ref = np.asarray(J.int4_matmul(jnp.asarray(x), jq, js, layer=1,
                                   backend="xla"))
    got = T.int4_matmul(torch.from_numpy(x),
                        torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)), layer=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref), rtol=0)
    # the card's large-M branch (dequantize in x's dtype + torch.matmul)
    # is the same function; on CPU tensors it can be called directly
    direct = T.int4_matmul_dequant(torch.from_numpy(x),
                                   torch.from_numpy(np.array(jq)),
                                   torch.from_numpy(np.array(js)), layer=1)
    np.testing.assert_allclose(direct.numpy(), ref, atol=_tol(ref), rtol=0)


def test_int4_cuda_wrapper_refuses_cpu_tensors(rng):
    x = torch.zeros(2, 256)
    q, s = T.quantize_int4(torch.zeros(256, 128))
    with pytest.raises(ValueError, match="CUDA"):
        T.int4_matmul_cuda(x, q, s)
