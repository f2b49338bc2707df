"""The port's ragged paged attention against the JAX kernel.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas kernel (in
interpret mode on the CPU) and ``paddle_ray_tpu_torch``'s wrapper, which
runs its plain PyTorch version for CPU tensors: GQA ratios 1/2/4, pages
shuffled across the pool, mixed chunk widths with dead slots, lengths at
page boundaries, a poisoned null page; and the int8 pool ``(k_q, k_s, v_q,
v_s)`` against the JAX ``_kernel_q8``.  Tolerances: float32 1e-5
(summation order differs); bfloat16 inputs 2e-2 (the two frameworks round
the bfloat16 intermediates at different places)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode, paged_ragged_attention as jax_ragged)
from paddle_ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_ragged_attention,
    paged_ragged_attention_plain)

D = 32
SCALE = 1.0 / D ** 0.5
PAGE = 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b, chunk, group, h_kv, pages_per_seq, q_lens, lengths,
            poison=0.0):
    """q, a pool of 1 + b * pages_per_seq pages with the sequences' pages
    scattered in shuffled order, the page table, lengths and q_lens."""
    r = np.random.RandomState(seed)
    n = 1 + b * pages_per_seq
    k = r.randn(n, PAGE, h_kv, D).astype(np.float32)
    v = r.randn(n, PAGE, h_kv, D).astype(np.float32)
    if poison:
        k[0] = poison
        v[0] = poison
    table = (1 + r.permutation(n - 1)).astype(np.int32).reshape(
        b, pages_per_seq)
    q = r.randn(b, chunk, group * h_kv, D).astype(np.float32)
    return (q, k, v, table, np.asarray(lengths, np.int32),
            np.asarray(q_lens, np.int32))


def _jax(q, k, v, table, lengths, q_lens, dtype=jnp.float32):
    out = jax_ragged(jnp.asarray(q, dtype), (jnp.asarray(k, dtype),
                                             jnp.asarray(v, dtype)),
                     jnp.asarray(table), jnp.asarray(lengths),
                     jnp.asarray(q_lens), scale=SCALE)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, table, lengths, q_lens, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a)                        # noqa: E731
    out = paged_ragged_attention(t(q).to(dtype), (t(k).to(dtype),
                                                  t(v).to(dtype)),
                                 t(table), t(lengths), t(q_lens),
                                 scale=SCALE)
    assert out.dtype == dtype
    return out.float().numpy()


# one full prefill chunk, a mid-prompt tail, two decode rows at page
# boundaries, a dead slot
MIXED_Q_LENS = [8, 3, 1, 1, 0, 5]
MIXED_LENGTHS = [PAGE, PAGE + 1, PAGE - 1, 29, 0, 2 * PAGE + 1]


@pytest.mark.parametrize("group", [1, 2, 4])
def test_ragged_matches_jax(group):
    args = _inputs(group, 6, 8, group, 2, 4, MIXED_Q_LENS, MIXED_LENGTHS,
                   poison=1e4)
    got, want = _port(*args), _jax(*args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32_TOL)
    # dead slot and pad rows are exactly zero
    assert (got[4] == 0).all()
    for b, ql in enumerate(MIXED_Q_LENS):
        assert (got[b, ql:] == 0).all(), f"pad rows of slot {b}"


@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_matches_jax_at_page_boundaries(group):
    lengths = [PAGE - 1, PAGE, PAGE + 1, 4 * PAGE]
    q, k, v, table, ln, _ = _inputs(10 + group, 4, 1, group, 2, 4,
                                    [1] * 4, lengths)
    got = paged_decode_attention(
        torch.from_numpy(q[:, 0]), (torch.from_numpy(k), torch.from_numpy(v)),
        torch.from_numpy(table), torch.from_numpy(ln), scale=SCALE)
    want = jax_decode(jnp.asarray(q[:, 0]), (jnp.asarray(k), jnp.asarray(v)),
                      jnp.asarray(table), jnp.asarray(ln), scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("group", [1, 2])
def test_bf16_inputs_match_jax(group):
    args = _inputs(20 + group, 6, 8, group, 2, 4, MIXED_Q_LENS,
                   MIXED_LENGTHS)
    got = _port(*args, dtype=torch.bfloat16)
    want = _jax(*args, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_poisoned_null_page_changes_nothing():
    clean = _inputs(30, 6, 8, 2, 2, 4, MIXED_Q_LENS, MIXED_LENGTHS)
    poisoned = _inputs(30, 6, 8, 2, 2, 4, MIXED_Q_LENS, MIXED_LENGTHS,
                       poison=1e4)
    np.testing.assert_array_equal(_port(*clean), _port(*poisoned))


def test_decode_is_chunk1_view():
    q, k, v, table, ln, _ = _inputs(40, 3, 1, 2, 2, 4, [1, 1, 0],
                                    [5, 23, 0])
    pool = (torch.from_numpy(k), torch.from_numpy(v))
    qt, tt, lt = map(torch.from_numpy, (q, table, ln))
    via_decode = paged_decode_attention(qt[:, 0], pool, tt, lt, scale=SCALE)
    via_ragged = paged_ragged_attention(qt, pool, tt, lt,
                                        (lt > 0).to(torch.int32),
                                        scale=SCALE)[:, 0]
    torch.testing.assert_close(via_decode, via_ragged, rtol=0, atol=0)
    assert (via_decode[2] == 0).all(), "dead slot must output zeros"


def test_cpu_tensors_run_the_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in
            _inputs(50, 6, 8, 1, 2, 4, MIXED_Q_LENS, MIXED_LENGTHS)]
    q, k, v, table, ln, ql = args
    before = paged_ragged_attention.launches
    got = paged_ragged_attention(q, (k, v), table, ln, ql, scale=SCALE)
    plain = paged_ragged_attention_plain(q, (k, v), table, ln, ql,
                                         scale=SCALE)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert paged_ragged_attention.launches == before


def test_validation():
    q, k, v, table, ln, ql = (torch.from_numpy(a) for a in _inputs(
        60, 1, 1, 1, 2, 2, [1], [4]))
    with pytest.raises(ValueError):        # h_q not a multiple of h_kv
        paged_ragged_attention(torch.zeros(1, 1, 3, D), (k, v), table, ln,
                               ql, scale=SCALE)
    with pytest.raises(ValueError):        # head_dim mismatch
        paged_ragged_attention(torch.zeros(1, 1, 2, D + 2), (k, v), table,
                               ln, ql, scale=SCALE)
    with pytest.raises(TypeError):         # an int8 pool of float values
        paged_ragged_attention(q, (k, k, v, v), table, ln, ql, scale=SCALE)
    with pytest.raises(ValueError):        # neither (k, v) nor 4 leaves
        paged_ragged_attention(q, (k, k, v), table, ln, ql, scale=SCALE)
    with pytest.raises(ValueError):        # no kernel for this device
        paged_ragged_attention(q.to("meta"), (k.to("meta"), v.to("meta")),
                               table, ln, ql, scale=SCALE)


def _q8_pool(k, v):
    """The pool quantized per (token, head) as the engine writes it."""
    from paddle_ray_tpu_torch.models.generation import _kv_quant
    kq, ks = _kv_quant(torch.from_numpy(k))
    vq, vs = _kv_quant(torch.from_numpy(v))
    return kq, ks[..., 0], vq, vs[..., 0]


@pytest.mark.parametrize("group", [1, 2, 4])
def test_int8_pool_matches_jax(group):
    q, k, v, table, ln, ql = _inputs(70 + group, 6, 8, group, 2, 4,
                                     MIXED_Q_LENS, MIXED_LENGTHS)
    pool = _q8_pool(k, v)
    pool[0][0] = 127                                # poisoned null page
    pool[1][0] = 1e4
    t = torch.from_numpy
    before = paged_ragged_attention.launches_q8
    got = paged_ragged_attention(t(q), pool, t(table), t(ln), t(ql),
                                 scale=SCALE).numpy()
    assert paged_ragged_attention.launches_q8 == before
    want = np.asarray(jax_ragged(
        jnp.asarray(q), tuple(jnp.asarray(p.numpy()) for p in pool),
        jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ql), scale=SCALE))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (got[4] == 0).all()
    for b, n in enumerate(MIXED_Q_LENS):
        assert (got[b, n:] == 0).all(), f"pad rows of slot {b}"
    # close to the unquantized pool's answer (int8 rounding apart)
    full = _port(q, k, v, table, ln, ql)
    np.testing.assert_allclose(got, full, rtol=0.05, atol=0.05)


def test_int8_pool_bf16_queries_match_jax():
    q, k, v, table, ln, ql = _inputs(80, 6, 8, 2, 2, 4, MIXED_Q_LENS,
                                     MIXED_LENGTHS)
    pool = _q8_pool(k, v)
    t = torch.from_numpy
    got = paged_ragged_attention(t(q).to(torch.bfloat16), pool, t(table),
                                 t(ln), t(ql), scale=SCALE)
    assert got.dtype == torch.bfloat16
    want = jax_ragged(jnp.asarray(q, jnp.bfloat16),
                      tuple(jnp.asarray(p.numpy()) for p in pool),
                      jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ql),
                      scale=SCALE)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
