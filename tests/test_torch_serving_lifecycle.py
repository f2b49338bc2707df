"""The port's request lifecycle against the JAX engine's, on the CPU.

Mirrors the lifecycle half of ``tests/test_chaos.py`` and the engine
surface of ``park_all``: cancel mid-flight (sync, async and under
speculation; the in-flight lane discarded through the zombie rollback)
and while queued; deadlines queued and mid-flight; preempt-and-restore
under a pool that forces a priority-5 request to evict a running one
(greedy and sampled, sync and async), the aged-priority starvation guard,
equal priorities that wait instead, blocked-admission rotation;
``park_all`` tickets resubmitted with ``committed=`` on a second engine.
Where the schedule is deterministic the port's tokens, counters,
statuses and pool / pagesan books equal the JAX engine's; deadlines
depend on the clock and are held to the uninterrupted stream instead.
Every engine runs ``sanitize=True``."""
import time

import numpy as np
import pytest

from paddle_ray_tpu_torch.serving import RequestStatus
# one_torch_thread: an autouse fixture, in force once imported
from torch_serving_pair import (PAGE, assert_same, books, drain_stream,
                                engines, first_diff_is_tie, models,
                                one_torch_thread, serve)

R = np.random.RandomState(12)


def _ref(tm, p, n, **skw):
    """The port's uncontended output (held to JAX elsewhere)."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    (out,) = serve(ServingEngine(tm, device="cpu", page_size=PAGE,
                                 max_batch=2), [(p, n, skw)])
    return out


def _both(port, ref, fn):
    """Run ``fn(engine) -> outputs`` on both engines and hold them
    together."""
    got, want = fn(port), fn(ref)
    assert_same(port, got, ref, want)
    return got


@pytest.mark.parametrize("mode", ["sync", "async", "spec"])
def test_cancel_midflight_matches_jax(mode):
    """Cancel mid-decode (a lane in flight under async): the committed
    tokens are a prefix of the uncancelled stream, the co-batched request
    is untouched, pages free, and the stream ends with its sentinel."""
    jm, tm = models(201)
    p1, p2 = R.randint(0, 97, (5,)), R.randint(0, 97, (7,))
    kw = dict(page_size=PAGE, max_batch=2,
              async_dispatch=mode == "async",
              spec_decode="ngram" if mode == "spec" else None, spec_k=3)
    port, ref = engines(jm, tm, **kw)
    steps = 2 if mode == "spec" else 5

    def drive(eng):
        r1 = eng.submit(p1, 40, stream=True)
        r2 = eng.submit(p2, 4)
        for _ in range(steps):
            eng.step()
        assert eng.cancel(r1) is True
        out = eng.run()
        return [np.asarray(out[r1]), np.asarray(out[r2])]

    got = _both(port, ref, drive)
    assert port.request_stats[0].status == RequestStatus.CANCELLED
    assert 0 < len(got[0]) < 40, "cancel was not mid-flight"
    np.testing.assert_array_equal(got[0], _ref(tm, p1, 40)[:len(got[0])])
    np.testing.assert_array_equal(got[1], _ref(tm, p2, 4))
    assert port.stats.cancelled_total == 1
    assert drain_stream(port.stream(0)) == got[0].tolist()
    assert port.pool.pages_in_use == port.prefix.cached_pages
    assert port.cancel(0) is False and port.cancel(99999) is False
    assert port.stream_status(0) == RequestStatus.CANCELLED


def test_cancel_queued_request_never_runs():
    jm, tm = models(203)
    p1, p2 = R.randint(0, 97, (5,)), R.randint(0, 97, (6,))
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=1)

    def drive(eng):
        r1 = eng.submit(p1, 4)
        r2 = eng.submit(p2, 4, stream=True)
        assert eng.cancel(r2) is True   # queued: removed outright
        out = eng.run()
        return [np.asarray(out[r1]), np.asarray(out[r2])]

    got = _both(port, ref, drive)
    assert len(got[1]) == 0
    assert port.request_stats[1].status == RequestStatus.CANCELLED
    assert port.stream(1).get_nowait() is None


def test_cancel_from_callback_is_deferred_to_the_step_boundary():
    """A cancel issued inside ``on_token`` applies at the next step
    boundary, as in the JAX engine."""
    jm, tm = models(219)
    p = R.randint(0, 97, (5,))
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=1,
                        async_dispatch=True)

    def drive(eng):
        seen = []

        def cb(rid, tok):
            seen.append(tok)
            if len(seen) == 3:
                assert eng.cancel(rid) is True
        rid = eng.submit(p, 20, on_token=cb)
        return [np.asarray(eng.run()[rid])]

    got = _both(port, ref, drive)
    assert 3 <= len(got[0]) < 20
    assert port.request_stats[0].status == RequestStatus.CANCELLED


@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
def test_deadline_expires_midflight_and_queued(async_dispatch):
    """A deadline expires a request mid-decode (committed tokens kept, a
    prefix of the full stream) and one still queued (no tokens)."""
    jm, tm = models(204)
    p = R.randint(0, 97, (5,))
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=1,
                      async_dispatch=async_dispatch)
    rid = port.submit(p, 50, deadline_s=0.3)
    rq = port.submit(R.randint(0, 97, (4,)), 4, deadline_s=0.05)
    for _ in range(6):
        port.step()
    time.sleep(0.35)
    out = port.run()
    assert port.request_stats[rid].status == RequestStatus.DEADLINE
    assert 0 < len(out[rid]) < 50
    np.testing.assert_array_equal(out[rid], _ref(tm, p, 50)[:len(out[rid])])
    assert port.request_stats[rq].status == RequestStatus.DEADLINE
    assert len(out[rq]) == 0
    assert port.stats.deadline_expired_total == 2
    assert port.pool.pages_in_use == port.prefix.cached_pages


def test_submit_and_cancel_validation_match_jax():
    jm, tm = models(205)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=1)
    for eng in (port, ref):
        with pytest.raises(ValueError):
            eng.submit(np.zeros((4,), np.int32), 2, deadline_s=0.0)
        with pytest.raises(ValueError):
            eng.cancel(0, status=RequestStatus.FAILED)
        with pytest.raises(ValueError, match="nothing left"):
            eng.submit(np.zeros((4,), np.int32), 2, committed=[1, 2])
        with pytest.raises(KeyError):
            eng.stream_status(0)


# ---------------------------------------------------------------------------
# preempt-and-restore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_preempt_and_restore_matches_jax(async_dispatch, sampled):
    """A decoding request preempted by a priority-5 arrival finishes equal
    to an unpreempted run, re-prefilling only the tail its parked prefix
    did not cover; the schedule equals the JAX engine's."""
    jm, tm = models(206)
    pa, pb = R.randint(0, 97, (5,)), R.randint(0, 97, (6,))
    skw = dict(temperature=0.9, top_k=8, seed=77) if sampled else {}
    want_a = _ref(tm, pa, 30, **skw)
    need_a = -(-(5 + 30 - 1) // PAGE)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2,
                        num_pages=1 + need_a + 1,
                        async_dispatch=async_dispatch)

    def drive(eng):
        ra = eng.submit(pa, 30, **skw)
        for _ in range(18):
            eng.step()
        hits = eng.stats.prefix_hit_tokens
        rb = eng.submit(pb, 12, priority=5)   # outranks A: preempts it
        out = eng.run()
        assert eng.stats.prefix_hit_tokens > hits
        return [np.asarray(out[ra]), np.asarray(out[rb])]

    got, want = drive(port), drive(ref)
    if sampled:
        assert first_diff_is_tie(tm, pa, got[0], want[0], skw)
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert_same(port, got, ref, want)
    sa = port.request_stats[0]
    assert port.stats.preempted_total >= 1
    assert sa.preemptions >= 1 and sa.retries >= 1 and sa.status == "OK"
    assert sa.prefix_hit_tokens > 0
    np.testing.assert_array_equal(got[0], want_a)
    np.testing.assert_array_equal(got[1], _ref(tm, pb, 12))
    port.clear_prefix_cache()
    assert port.pool.pages_in_use == 0


def test_preempt_starvation_guard_everyone_finishes():
    """Waves of priority-10 arrivals cannot starve a victim: each
    preemption ages it one tier and the retry budget pins it."""
    jm, tm = models(207)
    pa = R.randint(0, 97, (5,))
    highs_p = [R.randint(0, 97, (6,)) for _ in range(4)]
    need_a = -(-(5 + 30 - 1) // PAGE)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2,
                        num_pages=1 + need_a + 1, retry_budget=2)

    def drive(eng):
        ra = eng.submit(pa, 30)
        highs = []
        for k in range(4):
            for _ in range(6):
                eng.step()
            if eng.request_stats.get(ra) is None:
                highs.append(eng.submit(highs_p[k], 16, priority=10))
        out = eng.run()
        return [np.asarray(out[r]) for r in [ra] + highs]

    got = _both(port, ref, drive)
    sa = port.request_stats[0]
    assert sa.status == RequestStatus.OK
    assert port.stats.preempted_total >= 1, "no preemption exercised"
    assert sa.preemptions <= 2
    np.testing.assert_array_equal(got[0], _ref(tm, pa, 30))
    assert all(s.status == "OK" for s in port.request_stats.values())


def test_equal_priority_never_preempts_and_rotation_matches_jax():
    """Equal priorities wait (no preemption); a pool-pressure-blocked head
    rotates behind its tier so a smaller request finishes first."""
    jm, tm = models(209)
    pa, pb, pc = (R.randint(0, 97, (n,)) for n in (8, 20, 3))
    port, ref = engines(jm, tm, page_size=8, max_batch=2, num_pages=1 + 3,
                        prefix_cache=False)

    def drive(eng):
        ra = eng.submit(pa, 8)              # worst case 2 pages of 8
        for _ in range(3):
            eng.step()
        rb = eng.submit(pb, 3)              # needs 3 pages: blocked
        rc = eng.submit(pc, 2)              # needs 1 page: fits now
        order = []
        while eng._queue or eng.active or eng._inflight is not None:
            order += [rid for rid, _ in eng.step()]
        assert order.index(rc) < order.index(rb)
        return [np.asarray(eng._results[r]) for r in (ra, rb, rc)]

    got = _both(port, ref, drive)
    assert port.stats.preempted_total == 0
    assert port.stats.retries_total >= 1, "blocked head never requeued"
    for g, (p, n) in zip(got, ((pa, 8), (pb, 3), (pc, 2))):
        np.testing.assert_array_equal(g, _ref(tm, p, n))


# ---------------------------------------------------------------------------
# park_all and committed= resubmission
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
def test_park_all_then_resubmit_committed(async_dispatch):
    """``park_all`` mid-run hands back tickets equal to the JAX engine's
    (a decoding, a prefilling and a queued request); resubmitted with
    ``committed=`` on a second engine, every request finishes equal to
    an uninterrupted run, greedy and sampled; the first engine drains to
    its cache-held pages, its tickets' streams end and their status stays
    ``None``."""
    jm, tm = models(220)
    subs = [(R.randint(0, 97, (5,)), 30, {}),
            (R.randint(0, 97, (9,)), 30, dict(temperature=0.8, seed=3)),
            (R.randint(0, 97, (40,)), 6, {}),
            (R.randint(0, 97, (4,)), 5, {})]
    kw = dict(page_size=PAGE, max_batch=3, chunk_size=16,
              async_dispatch=async_dispatch)
    port, ref = engines(jm, tm, **kw)
    tickets = {}
    for eng in (port, ref):
        for p, n, skw in subs:
            eng.submit(p, n, stream=True, **skw)
        for _ in range(8):
            eng.step()
        tickets[eng is port] = eng.park_all()
    (pt, pfin), (jt, jfin) = tickets[True], tickets[False]
    assert [t["rid"] for t in pt] == [t["rid"] for t in jt]
    assert [r for r, _ in pfin] == [r for r, _ in jfin]
    for a, b in zip(pt, jt):
        assert {k: v for k, v in a.items() if k not in ("prompt",
                                                        "committed")} == \
            {k: v for k, v in b.items() if k not in ("prompt", "committed")}
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        if a["temperature"] == 0:
            assert a["committed"] == b["committed"]
    assert books(port) == books(ref)
    assert port.pool.pages_in_use == port.prefix.cached_pages
    for t in pt:
        drain_stream(port.stream(t["rid"]))
        assert port.stream_status(t["rid"]) is None
    second, _ = engines(jm, tm, **kw)
    rids = [second.submit(t["prompt"], t["max_new_tokens"],
                          committed=t["committed"] or None,
                          temperature=t["temperature"], top_k=t["top_k"],
                          top_p=t["top_p"], seed=t["seed"]) for t in pt]
    out = second.run()
    for rid, t in zip(rids, pt):
        skw = dict(temperature=t["temperature"], top_k=t["top_k"],
                   seed=t["seed"]) if t["temperature"] else {}
        np.testing.assert_array_equal(
            out[rid], _ref(tm, t["prompt"], t["max_new_tokens"], **skw))
    assert any(t["committed"] for t in pt), "nothing was mid-decode"


def test_prune_finished_drops_old_records():
    jm, tm = models(221)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=2)
    for n in (3, 4, 5):
        port.submit(R.randint(0, 97, (n,)), 2, stream=True)
    port.run()
    assert port.prune_finished(keep_last=1) == 2
    assert sorted(port._results) == [2] and sorted(port.request_stats) == [2]
    with pytest.raises(KeyError):
        port.stream(0)
