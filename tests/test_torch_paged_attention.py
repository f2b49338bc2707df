"""The port's ragged paged attention against the JAX kernel.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas kernel (in
interpret mode on the CPU) and ``paddle_ray_tpu_torch``'s wrapper, which
runs its plain PyTorch version for CPU tensors: GQA ratios 1/2/4, pages
shuffled across the pool, mixed chunk widths with dead slots, lengths at
page boundaries, a poisoned null page; and the int8 pool ``(k_q, k_s, v_q,
v_s)`` against the JAX ``_kernel_q8``, at head dims 32, 80 and 96 (a pool in
q's dtype against ``_kernel`` at 80 and 96 too), and the split-K plan both
pools launch with (the chooser's page runs for each pool's chunk, the
split-then-merge plain version against the unsplit one within 1e-6).  Tolerances: float32 1e-5
(summation order differs); bfloat16 inputs 2e-2 (the two frameworks round
the bfloat16 intermediates at different places)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode, paged_ragged_attention as jax_ragged)
from paddle_ray_tpu_torch.ops import _splitk, paged_attention as pa
from paddle_ray_tpu_torch.ops.paged_attention import (
    chunk_keys, paged_decode_attention, paged_ragged_attention,
    paged_ragged_attention_plain, paged_ragged_attention_split_plain,
    split_plan, split_ranges)

D = 32
SCALE = 1.0 / D ** 0.5
PAGE = 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b, chunk, group, h_kv, pages_per_seq, q_lens, lengths,
            poison=0.0, d=D):
    """q, a pool of 1 + b * pages_per_seq pages with the sequences' pages
    scattered in shuffled order, the page table, lengths and q_lens."""
    r = np.random.RandomState(seed)
    n = 1 + b * pages_per_seq
    k = r.randn(n, PAGE, h_kv, d).astype(np.float32)
    v = r.randn(n, PAGE, h_kv, d).astype(np.float32)
    if poison:
        k[0] = poison
        v[0] = poison
    table = (1 + r.permutation(n - 1)).astype(np.int32).reshape(
        b, pages_per_seq)
    q = r.randn(b, chunk, group * h_kv, d).astype(np.float32)
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


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 96])
def test_int8_pool_head_dims_80_96_match_jax(d, dtype, group):
    """gpt3-2.7b's head dim 80 and gpt3-760m's 96 over an int8 pool: the
    plain version against the Pallas ``_kernel_q8`` (interpret mode), GQA
    1/2/4, float32 and bfloat16 queries."""
    q, k, v, table, ln, ql = _inputs(90 + d + group, 6, 8, group, 2, 4,
                                     MIXED_Q_LENS, MIXED_LENGTHS, d=d)
    pool = _q8_pool(k, v)
    pool[0][0] = 127                                # poisoned null page
    pool[1][0] = 1e4
    t = torch.from_numpy
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL)
                     if dtype == "float32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    got = paged_ragged_attention(t(q).to(tdt), pool, t(table), t(ln), t(ql),
                                 scale=d ** -0.5)
    assert got.dtype == tdt
    want = jax_ragged(jnp.asarray(q, jdt),
                      tuple(jnp.asarray(p.numpy()) for p in pool),
                      jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ql),
                      scale=d ** -0.5)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **tol)
    for b, n in enumerate(MIXED_Q_LENS):
        assert (got[b, n:] == 0).all(), f"pad rows of slot {b}"


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 96])
def test_pool_in_q_dtype_head_dims_80_96_match_jax(d, dtype, group):
    """gpt3-2.7b's head dim 80 and gpt3-760m's 96 over a pool in q's
    dtype: the plain version against the Pallas ``_kernel`` (interpret
    mode), GQA 1/2/4, float32 and bfloat16, the null page poisoned."""
    args = _inputs(130 + d + group, 6, 8, group, 2, 4, MIXED_Q_LENS,
                   MIXED_LENGTHS, poison=1e4, d=d)
    q, k, v, table, ln, ql = args
    t = torch.from_numpy
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL)
                     if dtype == "float32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    got = paged_ragged_attention(t(q).to(tdt), (t(k).to(tdt), t(v).to(tdt)),
                                 t(table), t(ln), t(ql), scale=d ** -0.5)
    assert got.dtype == tdt
    want = jax_ragged(jnp.asarray(q, jdt), (jnp.asarray(k, jdt),
                                            jnp.asarray(v, jdt)),
                      jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ql),
                      scale=d ** -0.5)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **tol)
    for b, n in enumerate(MIXED_Q_LENS):
        assert (got[b, n:] == 0).all(), f"pad rows of slot {b}"


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_check_cuda_head_dims(d, q8):
    """The kernel takes head dims 64, 80, 96 and 128 over either pool
    (checked before any launch); another head dim raises."""
    table = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)

    def args(dim):
        q = torch.zeros(2, 1, 4, dim, dtype=torch.bfloat16)
        if q8:
            k = torch.zeros(7, 64, 4, dim, dtype=torch.int8)
            ks = torch.ones(7, 64, 4)
            return (q, k, k, ks, ks, table, ln, ln)
        k = torch.zeros(7, 64, 4, dim, dtype=torch.bfloat16)
        return (q, k, k, None, None, table, ln, ln)
    assert pa.KERNEL_HEAD_DIMS == (64, 80, 96, 128)
    pa._check_cuda(*args(d))
    with pytest.raises(ValueError, match=r"\(64, 80, 96, 128\)"):
        pa._check_cuda(*args(d + 16 if d == 128 else d - 16 if d == 64
                             else 112))


# (lengths, q_lens, page, table width): a long ragged decode with page
# boundaries and a dead slot, a mixed chunk, pages of 128, short pages
SPLIT_CASES = [
    ([1, 63, 64, 65, 700, 2048, 8192, 0], [1] * 7 + [0], 64, 128),
    ([1664, 1, 64, 65, 0, 2048], [128, 1, 1, 1, 0, 1], 64, 32),
    ([8192, 129, 128, 1, 5000], [1, 1, 1, 1, 0], 128, 64),
    ([31, 32, 33], [31, 1, 2], 32, 2),
    ([0, 0], [0, 0], 64, 4),
]


def _check_runs(runs, lengths, q_lens, page, n_blocks, n_splits):
    for ln, ql, slot_runs in zip(lengths, q_lens, runs):
        live = min(-(-ln // page), n_blocks) if ln > 0 and ql > 0 else 0
        covered = [p for p0, p1 in slot_runs for p in range(p0, p1)]
        assert covered == list(range(live))         # each page once
        assert len(slot_runs) <= live and len(slot_runs) <= n_splits
        assert all(p1 > p0 for p0, p1 in slot_runs)


@pytest.mark.parametrize("units_per_slot", [1, 16, 128])
@pytest.mark.parametrize("sm_count", [8, 132, 100000])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_plan_covers_every_live_page_once(case, sm_count,
                                                units_per_slot):
    """The chooser's runs cover each live slot's pages exactly once, a
    dead slot gets none, no run is empty, and there are never more splits
    than the longest slot's pages; a plan made from stale (shorter)
    lengths still covers every page (the last run takes the rest)."""
    lengths, q_lens, page, n_blocks = SPLIT_CASES[case]
    chunk = chunk_keys(page, True)
    n_splits, pps = split_plan(page, n_blocks, units_per_slot, sm_count,
                               lengths, chunk)
    longest = max([min(-(-n // page), n_blocks) for n in lengths], default=0)
    assert n_splits >= 1 and pps >= 1
    assert n_splits <= max(1, longest)
    assert (n_splits - 1) * pps < max(1, longest) <= n_splits * pps
    _check_runs(split_ranges(lengths, q_lens, page, n_blocks, n_splits, pps),
                lengths, q_lens, page, n_blocks, n_splits)
    stale = split_plan(page, n_blocks, units_per_slot, sm_count,
                       [n // 3 for n in lengths], chunk)
    _check_runs(split_ranges(lengths, q_lens, page, n_blocks, *stale),
                lengths, q_lens, page, n_blocks, stale[0])


@pytest.mark.parametrize("sm_count", [132, 1])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_split_merge_matches_unsplit_and_jax(group, sm_count):
    """Split-K over pages merged by the log-sum-exp rule, with the splits
    the chooser gives for these lengths (on 132 SMs two runs of 4 pages,
    on one SM a single run), equal to the unsplit plain version within
    1e-6 and to the Pallas ``_kernel_q8``.  Runs past a slot's length, and
    past an early prefill row's position, carry l = 0."""
    lengths = [PAGE, PAGE + 1, PAGE - 1, 29, 0, 8 * PAGE]
    q, k, v, table, ln, ql = _inputs(110 + group, 6, 8, group, 2, 8,
                                     MIXED_Q_LENS, lengths)
    pool = _q8_pool(k, v)
    t = torch.from_numpy
    args = (t(q), pool, t(table), t(ln), t(ql))
    n_splits, pps = split_plan(PAGE, 8, 2, sm_count, lengths,
                               chunk_keys(PAGE, True))
    assert (n_splits, pps) == ((2, 4) if sm_count == 132 else (1, 8))
    got = paged_ragged_attention_split_plain(
        *args, scale=SCALE, n_splits=n_splits, pages_per_split=pps).numpy()
    unsplit = paged_ragged_attention_plain(*args, scale=SCALE).numpy()
    np.testing.assert_allclose(got, unsplit, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), tuple(jnp.asarray(p.numpy()) for p in pool),
        jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ql), scale=SCALE))
    np.testing.assert_allclose(got, want, **F32_TOL)
    for b, n in enumerate(MIXED_Q_LENS):
        assert (got[b, n:] == 0).all(), f"pad rows of slot {b}"
    # runs of 1, 2 and 4 pages: most are fully masked for some row
    for n in (8, 4, 2):
        by_run = paged_ragged_attention_split_plain(
            *args, scale=SCALE, n_splits=n, pages_per_split=8 // n).numpy()
        np.testing.assert_allclose(by_run, unsplit, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk,group,host", [
    (1, 1, None), (1, 4, [64, 8 * PAGE, 1, 0]), (8, 2, [PAGE, 3, 0, 40]),
    (24, 1, [8 * PAGE] * 4)])
def test_q8_plan_is_split_plan_over_the_calls_tiles(chunk, group, host,
                                                    monkeypatch):
    """``kernel_plan`` -- the plan every launch uses, over an int8 pool or
    one in q's dtype -- is ``split_plan`` over the call's tiles of 16 (row,
    group member) pairs per kv head and the pool's chunk, every slot at
    the table's width when no host lengths are given."""
    h_kv, n_blocks, sms, page = 2, 8, 132, 64
    monkeypatch.setitem(_splitk._SM_COUNT, torch.device("cpu"), sms)
    q = torch.zeros(4, chunk, h_kv * group, D)
    tiles = -(-chunk * group // pa.TILE_PAIRS)
    table = torch.zeros(4, n_blocks, dtype=torch.int32)
    lengths = [n_blocks * page] * 4 if host is None else host
    for dtype, keys in ((torch.int8, 64), (torch.float32, 32)):
        pool = (torch.zeros(1 + 4 * n_blocks, page, h_kv, D, dtype=dtype),)
        assert chunk_keys(page, dtype == torch.int8) == keys
        assert pa.kernel_plan(q, pool, table, host) == split_plan(
            page, n_blocks, h_kv * tiles, sms, lengths, keys)


@pytest.mark.parametrize("int8_pool", [False, True])
@pytest.mark.parametrize("sm_count", [8, 132, 100000])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_plan_with_each_pools_chunk_covers_every_live_page_once(
        case, sm_count, int8_pool):
    """The chunk is 64 keys of an int8 pool and 32 of one in q's dtype, at
    most a page, and a whole number of chunks fill a page; the plan made
    with either chunk covers each live slot's pages exactly once, from
    fresh and from stale lengths.  With pages of 64 and more, the smaller
    chunk lets a split be half as many pages and still give each of the
    four warps a chunk."""
    lengths, q_lens, page, n_blocks = SPLIT_CASES[case]
    chunk = chunk_keys(page, int8_pool)
    assert chunk == min(page, 64 if int8_pool else 32) and page % chunk == 0
    for lens in (lengths, [n // 3 for n in lengths]):
        n_splits, pps = split_plan(page, n_blocks, 16, sm_count, lens, chunk)
        assert n_splits >= 1 and pps >= 1
        _check_runs(split_ranges(lengths, q_lens, page, n_blocks, n_splits,
                                 pps), lengths, q_lens, page, n_blocks,
                    n_splits)
    # one unit a slot on a card of many SMs: a split is the fewest pages
    # that give every warp a chunk
    one = split_plan(page, n_blocks, 1, 10 ** 6, [n_blocks * page], chunk)
    assert one[1] == min(n_blocks, -(-pa.WARPS // (page // chunk)))


@pytest.mark.parametrize("group", [1, 2, 4])
def test_split_merge_over_a_pool_in_q_dtype_matches_unsplit_and_jax(group):
    """The split-K plain version over a float32 pool in q's dtype, with the
    runs the plan gives for its chunk (two of 4 pages), equal to the
    unsplit plain version within 1e-6 and to the Pallas ``_kernel``; runs
    of 1, 2 and 4 pages too."""
    lengths = [PAGE, PAGE + 1, PAGE - 1, 29, 0, 8 * PAGE]
    q, k, v, table, ln, ql = _inputs(150 + group, 6, 8, group, 2, 8,
                                     MIXED_Q_LENS, lengths, poison=1e4)
    t = torch.from_numpy
    args = (t(q), (t(k), t(v)), t(table), t(ln), t(ql))
    n_splits, pps = split_plan(PAGE, 8, 2, 132, lengths,
                               chunk_keys(PAGE, False))
    assert (n_splits, pps) == (2, 4)
    unsplit = paged_ragged_attention_plain(*args, scale=SCALE).numpy()
    for n, per in ((n_splits, pps), (8, 1), (4, 2), (2, 4)):
        got = paged_ragged_attention_split_plain(
            *args, scale=SCALE, n_splits=n, pages_per_split=per).numpy()
        np.testing.assert_allclose(got, unsplit, rtol=1e-6, atol=1e-6)
    want = _jax(q, k, v, table, ln, ql)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for b, n in enumerate(MIXED_Q_LENS):
        assert (got[b, n:] == 0).all(), f"pad rows of slot {b}"


def test_split_counters_per_stream(monkeypatch):
    """Calls on two streams get two counter buffers, each zero, and one
    stream keeps its buffer (the kernel leaves it zero)."""
    monkeypatch.setattr(_splitk, "_COUNTERS", {})
    dev = torch.device("cpu")
    a, b = (_splitk.split_counters(dev, 1, 16),
            _splitk.split_counters(dev, 2, 16))
    assert a.data_ptr() != b.data_ptr()
    assert not a.any() and not b.any()
    assert _splitk.split_counters(dev, 1, 16).data_ptr() == a.data_ptr()
    assert _splitk.split_counters(dev, 1, 8192).numel() >= 8192
