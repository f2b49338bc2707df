"""The port's fused decode attention against the JAX kernel.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas kernels (in
interpret mode on the CPU, two T blocks of ``DECODE_BLOCK_T`` rows) and
``paddle_ray_tpu_torch``'s wrapper, which runs the plain version of the
cache's kind for CPU tensors: pos at the first row, at both edges of the
first block (the second block then fully masked) and at the last row; at
head dims 80 and 96 (gpt3-2.7b's and gpt3-760m's) for the bf16 and the int8
cache.
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
from paddle_ray_tpu_torch.ops import decode_attention as da
from paddle_ray_tpu_torch.ops.decode_attention import (
    DECODE_BLOCK_T, decode_split_plan, fused_decode_attention,
    fused_decode_attention_plain, fused_decode_attention_q8_plain,
    fused_decode_attention_split_plain)

B, H, D = 2, 3, 64
T = 2 * DECODE_BLOCK_T
SCALE = 1.0 / D ** 0.5
POSITIONS = [0, DECODE_BLOCK_T - 1, DECODE_BLOCK_T, T - 1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, d=D):
    r = np.random.RandomState(seed)
    return (r.randn(B, H, 1, d).astype(np.float32),
            r.randn(B, H, T, d).astype(np.float32),
            r.randn(B, H, T, d).astype(np.float32))


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


@pytest.mark.parametrize("pos", [0, DECODE_BLOCK_T + 44])
@pytest.mark.parametrize("kind", ["bf16", "q8"])
@pytest.mark.parametrize("d", [80, 96])
def test_head_dims_80_96_match_jax(d, kind, pos):
    """The plain versions at head dims 80 and 96 against the Pallas
    ``_kernel_bf16`` (a bf16 cache) and ``_kernel_q8`` (an int8 cache with
    bf16 queries), in interpret mode."""
    q, k, v = _inputs(60 + d + pos, d)
    scale = d ** -0.5
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    if kind == "bf16":
        want = jax_fused(qj, (jnp.asarray(k, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16)), pos, scale=scale)
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)   # noqa: E731
        got = fused_decode_attention(qt, (t(k), t(v)), pos, scale=scale)
    else:
        jk, jv = jax_kv_quant(jnp.asarray(k)), jax_kv_quant(jnp.asarray(v))
        want = jax_fused(qj, (*jk, *jv), pos, scale=scale)
        kq, ks = _kv_quant(torch.from_numpy(k))
        vq, vs = _kv_quant(torch.from_numpy(v))
        got = fused_decode_attention(qt, (kq, ks, vq, vs), pos, scale=scale)
    assert got.shape == (B, H, 1, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_check_cuda_head_dims(d, q8):
    """The CUDA kernel takes head dims 64, 80, 96 and 128 over a bf16 and
    an int8 cache (checked before any launch); another head dim raises."""
    def args(dim):
        q = torch.zeros(B, H, 1, dim, dtype=torch.bfloat16)
        if q8:
            kq = torch.zeros(B, H, T, dim, dtype=torch.int8)
            ks = torch.ones(B, H, T, 1)
            return q, (kq, ks, kq, ks)
        k = torch.zeros(B, H, T, dim, dtype=torch.bfloat16)
        return q, (k, k)
    assert da.KERNEL_HEAD_DIMS == (64, 80, 96, 128)
    da._check_cuda(*args(d))
    with pytest.raises(ValueError, match=r"\(64, 80, 96, 128\)"):
        da._check_cuda(*args(112 if d != 128 else 32))


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


@pytest.mark.parametrize("sm_count", [1, 16, 78, 132])
@pytest.mark.parametrize("bh", [1, 16, 128, 512])
def test_decode_split_plan_covers_every_row_once(bh, sm_count):
    """``decode_split_plan`` cuts a pair's live rows into runs of whole
    32-row groups that cover every row exactly once, none empty, never
    more runs than groups; a card full of pairs is not split, and one
    stream's long cache on a large card is."""
    for n_live in (*range(1, 300), 511, 512, 513, 2047, 2048, 8192):
        n, rps = decode_split_plan(bh, n_live, sm_count)
        groups = -(-n_live // da.ROW_GROUP)
        assert 1 <= n <= groups and rps % da.ROW_GROUP == 0
        runs = [range(i * rps, min((i + 1) * rps, n_live)) for i in range(n)]
        assert all(len(r) > 0 for r in runs)
        assert [t for r in runs for t in r] == list(range(n_live))
        if bh >= sm_count:
            assert n == 1
    assert decode_split_plan(16, 2048, 132)[0] > 1


def _split_inputs(kind, d, seed):
    """q and a cache of ``kind`` (f32, bf16 or q8 with float32 q) from
    numpy, for the port and for the JAX kernel."""
    q, k, v = _inputs(seed, d)
    if kind == "q8":
        jk, jv = jax_kv_quant(jnp.asarray(k)), jax_kv_quant(jnp.asarray(v))
        kq, ks = _kv_quant(torch.from_numpy(k))
        vq, vs = _kv_quant(torch.from_numpy(v))
        return (torch.from_numpy(q), (kq, ks, vq, vs), jnp.asarray(q),
                (*jk, *jv))
    jdt, tdt = ((jnp.float32, torch.float32) if kind == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    t = lambda a: torch.from_numpy(a).to(tdt)              # noqa: E731
    j = lambda a: jnp.asarray(a, jdt)                      # noqa: E731
    return t(q), (t(k), t(v)), j(q), (j(k), j(v))


@pytest.mark.parametrize("pos", [40, DECODE_BLOCK_T + 44, T - 1])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("d", [64, 96])
def test_split_plain_matches_unsplit_and_jax(d, kind, pos):
    """The kernel's split-K in plain PyTorch, with the split the kernel
    would take on a 132-SM card and with two uneven runs: equal to the
    unsplit plain version within 1e-6 (float32 outputs; bfloat16 ones
    within one rounding step) and to the Pallas kernel in interpret mode
    within the file's tolerances."""
    q, cache, jq, jcache = _split_inputs(kind, d, 70 + d + pos)
    scale = d ** -0.5
    plain = (fused_decode_attention_q8_plain if kind == "q8"
             else fused_decode_attention_plain)
    whole = plain(q, cache, pos, scale=scale)
    want = np.asarray(jax_fused(jq, jcache, pos, scale=scale).astype(
        jnp.float32))
    tol = BF16_TOL if kind == "bf16" else F32_TOL
    same = (dict(rtol=2.0 ** -7, atol=1e-6) if kind == "bf16"
            else dict(rtol=1e-6, atol=1e-6))
    plans = {decode_split_plan(B * H, pos + 1, 132),
             (2, -(-(pos + 1) * 3 // 4 // da.ROW_GROUP) * da.ROW_GROUP)}
    for n_splits, rps in plans:
        got = fused_decode_attention_split_plain(
            q, cache, pos, scale=scale, n_splits=n_splits,
            rows_per_split=rps)
        assert got.shape == (B, H, 1, d) and got.dtype == q.dtype
        torch.testing.assert_close(got, whole, **same)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_split_plain_refuses_empty_or_short_runs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(80))
    for n_splits, rps in ((0, 32), (4, 32), (1, 32), (2, 200)):
        with pytest.raises(ValueError):
            fused_decode_attention_split_plain(
                q, (k, v), 70, scale=SCALE, n_splits=n_splits,
                rows_per_split=rps)


@pytest.mark.parametrize("q8", [False, True])
def test_check_cuda_takes_generate_strided_q(q8):
    """``generate()`` passes ``q.transpose(1, 2)`` of a ``[B, 1, h, d]``
    slice of the qkv projection; the kernel reads it through its batch and
    head strides, so the CUDA checks take it as it lies (no copy), and
    refuse a q whose head_dim is not contiguous."""
    qkv = torch.zeros(B, 1, H, 3, D, dtype=torch.bfloat16)
    q = qkv[..., 0, :].transpose(1, 2)                     # [B, H, 1, D]
    assert q.shape == (B, H, 1, D) and not q.is_contiguous()
    assert q.stride(-1) == 1
    if q8:
        kq = torch.zeros(B, H, T, D, dtype=torch.int8)
        ks = torch.ones(B, H, T, 1)
        cache = (kq, ks, kq, ks)
    else:
        k = torch.zeros(B, H, T, D, dtype=torch.bfloat16)
        cache = (k, k)
    da._check(q, cache, 5)
    da._check_cuda(q, cache)
    bad = torch.zeros(B, H, D, 2, dtype=torch.bfloat16)[..., :1].transpose(
        -1, -2)                                            # d stride 2
    assert bad.shape == q.shape and bad.stride(-1) == 2
    with pytest.raises(ValueError, match="contiguous"):
        da._check_cuda(bad, cache)
