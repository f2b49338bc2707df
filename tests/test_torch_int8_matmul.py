"""The port's ``int8_matmul`` against the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU; the port's CPU path
is its plain version, which sums the int8 products in float64 (exact) and
rounds once to float32, as the kernel's int32 -> float32 cast does.  Both
then multiply by ``x_scale[m]`` and ``w_scale[n]`` in that order, so every
case is equal bit for bit (``assert_array_equal``): float32 and bfloat16
outputs, square and non-square shapes, and the form ``QuantizedLinear``
calls (``x_scale = 1``, ``w_scale = s_x * s_w``).  The block rule raises
the same ``ValueError`` on both sides; on the CPU no kernel launches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.ops.fused import int8_matmul as jax_int8_matmul
from paddle_ray_tpu_torch.ops.fused import (INT8_MAX_K, int8_matmul,
                                            int8_matmul_plain, int8_mm)


def _inputs(seed, m, k, n):
    r = np.random.RandomState(seed)
    xq = r.randint(-128, 128, (m, k)).astype(np.int8)
    wq = r.randint(-128, 128, (k, n)).astype(np.int8)
    xs = (r.rand(m) + 0.1).astype(np.float32) * 1e-2
    ws = (r.rand(n) + 0.1).astype(np.float32) * 1e-2
    return xq, wq, xs, ws


def _jax(xq, wq, xs, ws, out_dtype, blocks):
    out = jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                          jnp.asarray(ws), out_dtype=out_dtype, **blocks)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, xq, wq, xs, ws, out_dtype, **kw):
    out = fn(*(torch.from_numpy(a) for a in (xq, wq, xs, ws)),
             out_dtype=out_dtype, **kw)
    return out.float().numpy()


B128 = dict(block_m=128, block_n=128, block_k=128)
CASES = {
    "square_f32": ((256, 512, 384), B128, "f32"),
    "square_bf16": ((256, 512, 384), B128, "bf16"),
    "nonsquare_f32": ((128, 192, 320), dict(block_m=64, block_n=64,
                                            block_k=64), "f32"),
    "default_blocks_bf16": ((96, 160, 80), {}, "bf16"),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_pallas_kernel_bit_for_bit(case):
    (m, k, n), blocks, dt = CASES[case]
    jdt, tdt = DTYPES[dt]
    args = _inputs(m + k + n, m, k, n)
    want = _jax(*args, jdt, blocks)
    before = int8_matmul.launches
    got = _port(int8_matmul, *args, tdt, **blocks)
    plain = _port(int8_matmul_plain, *args, tdt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    assert int8_matmul.launches == before      # the CPU launches nothing


def test_quantized_linear_form_is_bit_exact():
    """``x_scale = 1`` and ``w_scale = s_x * s_w`` (the form
    ``QuantizedLinear`` calls) give JAX's ``acc * (s_x * s_w)``
    exactly, through the Pallas kernel and the port alike."""
    r = np.random.RandomState(3)
    m, k, n = 256, 512, 384
    xq, wq, _, ws = _inputs(5, m, k, n)
    x_s = np.float32(r.rand() * 0.05 + 0.01)
    ones = np.ones(m, np.float32)
    scale = (x_s * ws).astype(np.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    want = acc.astype(np.float32) * (x_s * ws[None, :])
    jax_out = _jax(xq, wq, ones, scale, jnp.float32, B128)
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(
        _port(int8_matmul, xq, wq, ones, scale, torch.float32, **B128),
        want)
    np.testing.assert_array_equal(
        _port(int8_mm, xq[:37], wq, ones[:37], scale, torch.float32),
        want[:37])


@pytest.mark.parametrize("shapes,msg", [
    (((64, 32), (48, 16)), "inner dims mismatch: 32 vs 48"),
    (((100, 64), (64, 64)), "M=100 not divisible by block 64"),
    (((64, 64), (64, 100)), "N=100 not divisible by block 64"),
    (((64, 96), (96, 64)), "K=96 not divisible by block 64"),
])
def test_value_errors_match_jax(shapes, msg):
    (m, k), (k2, n) = shapes
    r = np.random.RandomState(0)
    xq = r.randint(-128, 128, (m, k)).astype(np.int8)
    wq = r.randint(-128, 128, (k2, n)).astype(np.int8)
    xs, ws = np.ones(m, np.float32), np.ones(n, np.float32)
    blocks = dict(block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match=msg):
        jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                        jnp.asarray(ws), **blocks)
    with pytest.raises(ValueError, match=msg):
        int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, xs, ws)),
                    **blocks)


def test_argument_checks():
    xq = torch.zeros(8, 16, dtype=torch.int8)
    wq = torch.zeros(16, 4, dtype=torch.int8)
    xs, ws = torch.ones(8), torch.ones(4)
    with pytest.raises(TypeError, match="xq must be int8"):
        int8_mm(xq.float(), wq, xs, ws)
    with pytest.raises(TypeError, match="wq must be int8"):
        int8_matmul(xq, wq.to(torch.int32), xs, ws)
    with pytest.raises(ValueError, match="2-D"):
        int8_mm(xq[None], wq, xs, ws)
    with pytest.raises(ValueError, match=r"x_scale must be \[8\]"):
        int8_mm(xq, wq, torch.ones(7), ws)
    with pytest.raises(ValueError, match=r"w_scale must be \[4\]"):
        int8_matmul(xq, wq, xs, torch.ones(4, 1))
    with pytest.raises(TypeError, match="x_scale must be floating"):
        int8_mm(xq, wq, xs.int(), ws)
    with pytest.raises(TypeError, match="out_dtype"):
        int8_mm(xq, wq, xs, ws, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="block_k must be positive"):
        int8_matmul(xq, wq, xs, ws, block_k=0)
    assert INT8_MAX_K * 128 * 128 < 2 ** 31
    out = int8_mm(xq, wq, xs.double(), ws.bfloat16(),
                  out_dtype=torch.bfloat16)
    assert out.shape == (8, 4) and out.dtype == torch.bfloat16
    assert not out.float().any()
