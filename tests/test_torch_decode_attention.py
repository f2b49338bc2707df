"""The port's fused decode attention against the JAX kernel.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas kernels (in
interpret mode on the CPU, two T blocks of ``DECODE_BLOCK_T`` rows) and
``paddle_ray_tpu_torch``'s wrapper, which runs the plain version of the
cache's kind for CPU tensors: pos at the first row, at both edges of the
first block (the second block then fully masked) and at the last row.
Tolerances: float32 1e-5 (summation order differs); bfloat16 2e-2 (the
frameworks round the bfloat16 intermediates at different places)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.models.generation import _kv_quant as jax_kv_quant
from paddle_ray_tpu.ops.decode_attention import (
    DECODE_BLOCK_T as JAX_BLOCK_T, fused_decode_attention as jax_fused)
from paddle_ray_tpu_torch.models.generation import _kv_quant
from paddle_ray_tpu_torch.ops.decode_attention import (
    DECODE_BLOCK_T, fused_decode_attention, fused_decode_attention_plain,
    fused_decode_attention_q8_plain)

B, H, D = 2, 3, 64
T = 2 * DECODE_BLOCK_T
SCALE = 1.0 / D ** 0.5
POSITIONS = [0, DECODE_BLOCK_T - 1, DECODE_BLOCK_T, T - 1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, H, 1, D).astype(np.float32),
            r.randn(B, H, T, D).astype(np.float32),
            r.randn(B, H, T, D).astype(np.float32))


def test_block_constant_matches_jax():
    assert DECODE_BLOCK_T == JAX_BLOCK_T


@pytest.mark.parametrize("pos", POSITIONS)
def test_f32_matches_jax(pos):
    q, k, v = _inputs(pos)
    want = jax_fused(jnp.asarray(q), (jnp.asarray(k), jnp.asarray(v)), pos,
                     scale=SCALE)
    got = fused_decode_attention(torch.from_numpy(q), (torch.from_numpy(k),
                                                       torch.from_numpy(v)),
                                 pos, scale=SCALE)
    assert got.shape == (B, H, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("pos", [0, DECODE_BLOCK_T + 44])
def test_bf16_matches_jax(pos):
    q, k, v = _inputs(10 + pos)
    want = jax_fused(jnp.asarray(q, jnp.bfloat16),
                     (jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(v, jnp.bfloat16)), pos, scale=SCALE)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)   # noqa: E731
    got = fused_decode_attention(t(q), (t(k), t(v)), pos, scale=SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("pos", POSITIONS)
def test_q8_matches_jax(pos):
    q, k, v = _inputs(20 + pos)
    jk, jv = jax_kv_quant(jnp.asarray(k)), jax_kv_quant(jnp.asarray(v))
    want = jax_fused(jnp.asarray(q), (*jk, *jv), pos, scale=SCALE)
    kq, ks = _kv_quant(torch.from_numpy(k))
    vq, vs = _kv_quant(torch.from_numpy(v))
    # the int8 cache the port writes is the JAX package's, bit for bit
    for a, b in zip((kq, ks, vq, vs), (*jk, *jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fused_decode_attention(torch.from_numpy(q), (kq, ks, vq, vs), pos,
                                 scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_rows_past_pos_change_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(30))
    pos = DECODE_BLOCK_T - 1
    clean = fused_decode_attention(q, (k, v), pos, scale=SCALE)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, pos + 1:] = 1e4
    v2[:, :, pos + 1:] = float("nan")
    torch.testing.assert_close(
        fused_decode_attention(q, (k2, v2), pos, scale=SCALE), clean,
        rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(40))
    kq, ks = _kv_quant(k)
    vq, vs = _kv_quant(v)
    before = (fused_decode_attention.launches,
              fused_decode_attention.launches_q8)
    torch.testing.assert_close(
        fused_decode_attention(q, (k, v), 17, scale=SCALE),
        fused_decode_attention_plain(q, (k, v), 17, scale=SCALE),
        rtol=0, atol=0)
    torch.testing.assert_close(
        fused_decode_attention(q, (kq, ks, vq, vs), 17, scale=SCALE),
        fused_decode_attention_q8_plain(q, (kq, ks, vq, vs), 17,
                                        scale=SCALE),
        rtol=0, atol=0)
    assert (fused_decode_attention.launches,
            fused_decode_attention.launches_q8) == before


def test_validation():
    q, k, v = (torch.from_numpy(a) for a in _inputs(50))
    with pytest.raises(ValueError):            # pos past the cache
        fused_decode_attention(q, (k, v), T, scale=SCALE)
    with pytest.raises(ValueError):            # q is not one row
        fused_decode_attention(torch.cat([q, q], 2), (k, v), 0, scale=SCALE)
    with pytest.raises(ValueError):            # cache of another head count
        fused_decode_attention(q, (k[:, :2], v[:, :2]), 0, scale=SCALE)
    with pytest.raises(ValueError):            # neither 2 nor 4 leaves
        fused_decode_attention(q, (k, v, v), 0, scale=SCALE)
    with pytest.raises(ValueError):            # no kernel for this device
        fused_decode_attention(q.to("meta"), (k.to("meta"), v.to("meta")),
                               0, scale=SCALE)
