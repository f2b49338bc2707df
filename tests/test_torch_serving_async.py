"""The port's double-buffered dispatch against the JAX engine's, on the
CPU.

Mirrors ``tests/test_async_engine.py``: the async engine's tokens,
counters and pool / pagesan books equal the JAX async engine's and the
sync engine's on a mixed prefill + decode workload, greedy and sampled,
with and without speculation; step N's tokens are fetched only after step
N + 1 was dispatched, with exactly one ``_fetch`` a step in steady
decode (on the card ``chip_smoke.py``'s ``serve_async`` also runs the
steady dispatches under ``torch.cuda.set_sync_debug_mode("error")``);
eos found while the next lane is in flight retires the slot as a zombie;
streams and callbacks deliver exactly the drained output; the shadow
books equal the pool's at every reconcile; a step's staging is a
snapshot of the page table.  Every engine runs ``sanitize=True``."""
import types

import numpy as np
import pytest

# one_torch_thread: an autouse fixture, in force once imported
from torch_serving_pair import (PAGE, assert_same, books, drain_stream,
                                engines, first_diff_is_tie, models,
                                one_torch_thread, pair, serve)

R = np.random.RandomState(3)
MIXED = [(R.randint(0, 97, (t0,)), n)
         for t0, n in ((5, 4), (11, 6), (3, 5), (40, 3), (9, 7))]
SAMPLING = dict(temperature=0.9, top_k=8, top_p=0.9)
KW = dict(page_size=PAGE, max_batch=3, chunk_size=16)


def _submits(sampled):
    return [(p, n, dict(SAMPLING, seed=100 + i) if sampled and i % 2 else {})
            for i, (p, n) in enumerate(MIXED)]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_async_matches_jax_and_sync(sampled, spec):
    """Async dispatch is a scheduling change only: the async engine's
    tokens equal the sync engine's exactly; against the JAX async engine
    greedy tokens, counters and books are equal and a sampled token may
    differ only at a 1e-5 tie of its perturbed logits."""
    jm, tm = models(90)
    kw = dict(KW, spec_decode="ngram" if spec else None, spec_k=3)
    subs = _submits(sampled)
    port, ref = engines(jm, tm, async_dispatch=True, **kw)
    got, want = serve(port, subs), serve(ref, subs)
    if sampled:
        for (p, n, skw), a, b in zip(subs, got, want):
            if skw:
                assert first_diff_is_tie(tm, p, a, b, skw)
            else:
                np.testing.assert_array_equal(a, b)
    else:
        assert_same(port, got, ref, want)
    sync, _ = engines(jm, tm, **kw)
    for a, b in zip(got, serve(sync, subs)):
        np.testing.assert_array_equal(a, b)
    assert port.executable_count <= port.executable_budget
    if spec:
        assert port.stats.draft_tokens == sync.stats.draft_tokens > 0


def test_one_fetch_per_step_after_the_next_dispatch():
    """Instrumenting the engine's two transfer points: in steady decode
    step N's fetch comes after step N + 1's dispatch, and every step()
    call makes exactly one fetch (none before its dispatch)."""
    jm, tm = models(92)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=1,
                      async_dispatch=True)
    events = []
    dispatch, fetch = type(port)._dispatch, type(port)._fetch

    def d(self, *a):
        inf = dispatch(self, *a)
        events.append(("dispatch", inf.step_id))
        return inf

    def f(self, inf):
        events.append(("fetch", inf.step_id))
        return fetch(self, inf)

    port._dispatch = types.MethodType(d, port)
    port._fetch = types.MethodType(f, port)
    prompt = R.randint(0, 97, (5,))
    rid = port.submit(prompt, 12)
    per_step = []
    while port.pending or port.active or port._inflight is not None:
        n0 = len(events)
        port.step()
        per_step.append([k for k, _ in events[n0:]])
    (want,) = serve(engines(jm, tm, page_size=PAGE, max_batch=1)[0],
                    [(prompt, 12, {})])
    np.testing.assert_array_equal(port._results[rid], want)
    fetched = [s for k, s in events if k == "fetch"]
    dispatched = [s for k, s in events if k == "dispatch"]
    assert fetched == sorted(fetched) == dispatched
    pos = {e: i for i, e in enumerate(events)}
    for sid in fetched:
        if ("dispatch", sid + 1) in pos:
            assert pos[("dispatch", sid + 1)] < pos[("fetch", sid)], events
    assert sum(("dispatch", s + 1) in pos for s in fetched) \
        >= len(fetched) - 1
    # steady decode: each step dispatches first, then fetches once
    steady = per_step[1:-1]
    assert steady and all(k == ["dispatch", "fetch"] for k in steady), \
        per_step


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_async_eos_zombie_matches_jax(sampled):
    """eos found at reconcile N while N + 1 is in flight: the in-flight
    lane is discarded (rows rolled back, pages freed) and tokens, counters
    and books equal the JAX async engine's and the sync engine's."""
    jm, tm = models(93)
    skw = dict(temperature=1.3, seed=7) if sampled else {}
    p = R.randint(0, 97, (6,))
    (full,) = serve(engines(jm, tm, page_size=PAGE, max_batch=2)[0],
                    [(p, 12, skw)])
    # the first token that first occurs mid-decode; a greedy stream of
    # this small model repeats one token, whose eos lands on the first
    # token -- the decode lane dispatched behind it is then the zombie
    k = next((k for k in range(1, len(full) - 1)
              if int(full[k]) not in [int(t) for t in full[:k]]), 0)
    assert k > 0 or not sampled
    eos = int(full[k])
    kw = dict(page_size=PAGE, max_batch=2, eos_token_id=eos)
    port, (got,) = pair(jm, tm, [(p, 12, skw)], async_dispatch=True, **kw)
    np.testing.assert_array_equal(got, full[:k + 1])
    assert port.pool.pages_in_use == port.prefix.cached_pages


@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
def test_streaming_order_truncation_and_itl(async_dispatch):
    """Callback and queue deliver every committed token in order, equal
    to the drained output (eos truncation included), with a commit
    timestamp a token.  A sampled stream (a greedy stream of this small
    model repeats one token), cut by an eos that first occurs mid-decode;
    the output equals the sync engine's and, up to a 1e-5 tie, the JAX
    engine's."""
    jm, tm = models(95)
    p = R.randint(0, 97, (6,))
    skw = dict(temperature=1.3, seed=5)
    (full,) = serve(engines(jm, tm, page_size=PAGE, max_batch=2)[0],
                    [(p, 12, skw)])
    k = next(k for k in range(2, len(full) - 1)
             if int(full[k]) not in [int(t) for t in full[:k]])
    eos = int(full[k])
    got = []
    port, jax_eng = engines(jm, tm, page_size=PAGE, max_batch=2,
                            eos_token_id=eos, async_dispatch=async_dispatch)
    rid = port.submit(p, 12, on_token=lambda r, t: got.append((r, t)),
                      stream=True, **skw)
    out = port.run()[rid]
    np.testing.assert_array_equal(out, full[:k + 1])
    (want,) = serve(jax_eng, [(p, 12, skw)])
    assert first_diff_is_tie(tm, p, out, want[:len(out)], skw)
    assert drain_stream(port.stream(rid)) == out.tolist()
    assert got == [(rid, int(t)) for t in out]
    st = port.request_stats[rid]
    assert len(st.token_t) == len(out) and st.token_t == sorted(st.token_t)
    assert len(st.itl_s) == len(out) - 1
    assert all(g >= 0 for g in st.itl_s)
    assert st.ttft_s <= st.total_s
    assert port.stream_status(rid) == "OK"


def test_async_shadow_books_exact_at_every_reconcile():
    """``shadow_stats() == pool.stats()`` at every reconcile of the
    double-buffered loop, and the final books equal the JAX engine's."""
    jm, tm = models(96)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2, chunk_size=16,
                        async_dispatch=True)
    reconcile = type(port)._reconcile
    checks = []

    def rec(self, inf, finished):
        reconcile(self, inf, finished)
        assert self.sanitizer.shadow_stats() == self.pool.stats()
        self.sanitizer.verify_pool()
        checks.append(inf.step_id)

    port._reconcile = types.MethodType(rec, port)
    subs = _submits(False)
    got, want = serve(port, subs), serve(ref, subs)
    assert_same(port, got, ref, want)
    assert len(checks) == port.stats.mixed_steps > 0


def test_async_width_family_matches_jax():
    """After a warm wave, further async traffic (sampled too) in the same
    widths runs no new width; the count equals the JAX engine's."""
    jm, tm = models(97)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2,
                        async_dispatch=True)
    for eng in (port, ref):
        for wave in ((5, 11), (4, 7)):
            for n in wave:
                eng.submit(np.arange(n) % 97, 4)
            eng.run()
    warm, rc = port.executable_count, port.recompiles
    assert warm <= port.executable_budget
    for eng in (port, ref):
        for n in (6, 12):
            eng.submit(np.arange(n) % 97, 5, temperature=0.5, seed=n)
            eng.run()
    assert port.executable_count == warm == ref.executable_count
    assert port.recompiles == rc


def test_step_staging_snapshots_the_table():
    """A dispatched step's inputs are a copy: rewriting the host page
    table and the staging views after dispatch leaves the step's tokens
    unchanged, and the two staging sets alternate."""
    jm, tm = models(98)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=2,
                      async_dispatch=True)
    p = R.randint(0, 97, (20,))
    rid = port.submit(p, 6)
    port.step()                                  # prefill chunk 1
    inf = port._inflight
    assert inf is not None and inf.buffers is port._buffers[inf.step_id % 2]
    saved = port._table.copy()
    port._table[:] = 0                           # vandalise the host side
    inf.buffers._i32[:] = 0
    port._table[:] = saved
    out = port.run()[rid]
    (want,) = serve(engines(jm, tm, page_size=PAGE, max_batch=2)[0],
                    [(p, 6, {})])
    np.testing.assert_array_equal(out, want)


def test_stream_sentinel_delivered_when_run_dies():
    """A callback raising kills run(), and the stream still ends."""
    jm, tm = models(100)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=1,
                      async_dispatch=True)

    def boom(r, t):
        raise RuntimeError("consumer callback exploded")

    rid = port.submit(R.randint(0, 97, (5,)), 8, on_token=boom, stream=True)
    with pytest.raises(RuntimeError, match="exploded"):
        port.run()
    assert port.stream(rid).get(timeout=1) is None


def test_any_int_seed_folds_to_uint32_like_jax():
    """Seeds outside uint32 fold to it: -1 and 2**32 - 1 draw one stream,
    equal to the JAX engine's."""
    jm, tm = models(99)
    p = R.randint(0, 97, (6,))
    outs = []
    for seed in (-1, 2 ** 32 - 1, 2 ** 32):
        port, ref = engines(jm, tm, page_size=PAGE, max_batch=1)
        skw = dict(temperature=1.0, seed=seed)
        (a,), (b,) = serve(port, [(p, 6, skw)]), serve(ref, [(p, 6, skw)])
        assert first_diff_is_tie(tm, p, a, b,
                                 dict(skw, seed=seed & 0xFFFFFFFF))
        outs.append(a)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert len(outs[2]) == 6
    assert books(port) == books(ref)
