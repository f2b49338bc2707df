"""The port's fault injection and step-failure containment against the
JAX engine's, on the CPU.

Mirrors the containment half of ``tests/test_chaos.py``: ``FaultPlan``
seeded determinism, consumption and round-trip, and the same schedule as
the JAX ``FaultPlan`` from one seed (the dumps load across); one fault of
each kind over sync, async and spec engines, recovered to the fault-free
tokens with the JAX engine's failures, retries and books; consecutive
failures draining every request ``FAILED``; a deferred preemption whose
victim fell back into prefill; a one-shot placement fault; a spent retry
budget; the stall watchdog; replay from a dumped plan; an empty plan equal
to none; and the property suite -- seeded random plans over mixed sync /
async / spec, sampled and prioritised workloads with late priority-5
arrivals and mid-flight cancels on a tight pool, port and JAX engine under
the same plan: equal fired events, tokens, statuses, counters and books,
shadow books equal to the pool's at every reconcile, and every ``OK``
request equal to the fault-free run.  Unlike the JAX engine, the port
contains only the injected ``ChaosError`` and the pool's ``MemoryError``:
a CUDA error (a kernel wrapper's launch failure) propagates, uncounted.
Every engine runs ``sanitize=True``."""
import types

import numpy as np
import pytest

from paddle_ray_tpu.serving import FaultEvent as JaxFaultEvent
from paddle_ray_tpu.serving import FaultPlan as JaxFaultPlan
from paddle_ray_tpu_torch.serving import (EngineStallError, FaultEvent,
                                          FaultPlan, RequestStatus)
from paddle_ray_tpu_torch.serving import engine as engine_mod
# one_torch_thread: an autouse fixture, in force once imported
from torch_serving_pair import (PAGE, assert_same, books, drain_stream,
                                engines, models, one_torch_thread, serve)

R = np.random.RandomState(12)


def _plans(events):
    """The same schedule as a port and a JAX plan: ``[(step, kind,
    keywords)]``."""
    return (FaultPlan([FaultEvent(s, k, **kw) for s, k, kw in events]),
            JaxFaultPlan([JaxFaultEvent(s, k, **kw) for s, k, kw in events]))


def _armed(jm, tm, port_plan, jax_plan, **kw):
    port, ref = engines(jm, tm, **kw)
    for eng, plan in ((port, port_plan), (ref, jax_plan)):
        eng.chaos = plan
        eng.pool.fault_injector = eng._pool_fault
    return port, ref


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------
def test_fault_plan_determinism_roundtrip_and_jax_schedule():
    a, b = FaultPlan.random(42, steps=50), FaultPlan.random(42, steps=50)
    assert [e.as_dict() for e in a.events()] == \
        [e.as_dict() for e in b.events()]
    assert [e.as_dict() for e in a.events()] == \
        [e.as_dict() for e in JaxFaultPlan.random(42, steps=50).events()]
    assert [e.as_dict() for e in a.events()] != \
        [e.as_dict() for e in FaultPlan.random(43, steps=50).events()]
    ev = a.events()[0]
    assert a.take(ev.kind, ev.step) is ev
    assert a.take(ev.kind, ev.step) is None
    assert a.fired_log() == [(ev.step, ev.kind)]
    c = FaultPlan.from_dict(a.to_dict())
    assert [e.as_dict() for e in c.events()] == \
        [e.as_dict() for e in b.events()] and c.fired_log() == []
    # dumps load across the packages
    j = JaxFaultPlan.random(7, steps=30, p_dispatch=0.2)
    assert FaultPlan.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert a.reset().take(ev.kind, ev.step).as_dict() == ev.as_dict()
    m = FaultPlan.merge(FaultPlan([FaultEvent(1, "fetch")]),
                        FaultPlan([FaultEvent(2, "fetch")]))
    assert m.fired_log() == [] and m.pending == 2
    for bad in ([FaultEvent(1, "nonsense")],
                [FaultEvent(1, "fetch"), FaultEvent(1, "fetch")]):
        with pytest.raises(ValueError):
            FaultPlan(bad)
    with pytest.raises(ValueError):
        FaultPlan.from_dict({"events": []})


def test_stats_schema_zeros_when_unused():
    jm, tm = models(200)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2)
    sub = [(R.randint(0, 97, (5,)), 4, {})]
    assert_same(port, serve(port, sub), ref, serve(ref, sub))
    sd = port.stats.to_dict()
    for key in ("preempted_total", "cancelled_total",
                "deadline_expired_total", "step_failures", "retries_total"):
        assert sd[key] == 0, key
    rd = port.request_stats[0].to_dict()
    assert rd["status"] == "OK" and rd["retries"] == rd["preemptions"] == 0


# ---------------------------------------------------------------------------
# step-failure containment
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sync", "async", "spec"])
def test_injected_faults_recover_like_jax(mode):
    """One fault of each kind mid-flight: the broken step(s) are
    discarded and rolled back, the rows retried, and the tokens equal the
    fault-free run; fired events, failures, retries and books equal the
    JAX engine's."""
    jm, tm = models(210)
    prompts = [R.randint(0, 97, (n,)) for n in (5, 11, 4)]
    sub = [(p, 6, {}) for p in prompts]
    kw = dict(page_size=PAGE, max_batch=3, chunk_size=16, retry_budget=10,
              async_dispatch=mode == "async",
              spec_decode="ngram" if mode == "spec" else None, spec_k=3)
    clean = serve(engines(jm, tm, **kw)[0], sub)
    pp, jp = _plans([(3, "dispatch", {}),
                     (4, "fetch_delay", dict(delay_s=0.001)),
                     (5, "fetch", {}),
                     (6, "pool_spike", dict(pages=2, hold_steps=2)),
                     (7, "pool_alloc", {})])
    port, ref = _armed(jm, tm, pp, jp, **kw)
    got, want = serve(port, sub), serve(ref, sub)
    assert_same(port, got, ref, want)
    assert pp.fired_log() == jp.fired_log() and len(pp.fired_log()) >= 3
    assert port.chaos_fired == ref.chaos_fired
    assert port.stats.step_failures >= 2 and port.stats.retries_total >= 1
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    assert all(s.status == "OK" for s in port.request_stats.values())


def test_consecutive_failures_drain_gracefully():
    """K consecutive discarded steps: every live request fails with its
    committed tokens and run() returns instead of looping."""
    jm, tm = models(211)
    events = [(s, "dispatch", {}) for s in range(2, 40)]
    pp, jp = _plans(events)
    port, ref = _armed(jm, tm, pp, jp, page_size=PAGE, max_batch=2,
                       retry_budget=100, max_step_failures=3)
    sub = [(R.randint(0, 97, (n,)), 6, {}) for n in (5, 7)]
    assert_same(port, serve(port, sub), ref, serve(ref, sub))
    assert port.failed_drain is not None
    assert port.stats.step_failures >= 3
    assert all(s.status == RequestStatus.FAILED
               for s in port.request_stats.values())
    assert port.pool.pages_in_use == port.prefix.cached_pages


def test_preempt_pending_cleared_when_victim_back_in_prefill():
    jm, tm = models(218)
    p = R.randint(0, 97, (40,))
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=1)

    def drive(eng):
        rid = eng.submit(p, 4)
        eng.step()                      # chunk of 32: still prefilling
        assert eng._slots[0].prefilling
        eng._slots[0].preempt_pending = True
        return [np.asarray(eng.run()[rid])]

    assert_same(port, drive(port), ref, drive(ref))
    assert port.stats.preempted_total == 0


def test_transient_alloc_fault_at_placement_does_not_deadlock():
    jm, tm = models(217)
    pp, jp = _plans([(1, "pool_alloc", {})])
    port, ref = _armed(jm, tm, pp, jp, page_size=PAGE, max_batch=1)
    sub = [(R.randint(0, 97, (5,)), 4, {})]
    got = serve(port, sub)
    assert_same(port, got, ref, serve(ref, sub))
    assert pp.fired_log() == [(1, "pool_alloc")] and len(got[0]) == 4


def test_retry_budget_exhaustion_fails_request_terminally():
    jm, tm = models(212)
    pp, jp = _plans([(s, "fetch", {}) for s in range(2, 30, 2)])
    port, ref = _armed(jm, tm, pp, jp, page_size=PAGE, max_batch=1,
                       retry_budget=1, max_step_failures=100)
    sub = [(R.randint(0, 97, (5,)), 8, {})]
    assert_same(port, serve(port, sub), ref, serve(ref, sub))
    assert port.request_stats[0].status == RequestStatus.FAILED
    assert port.request_stats[0].retries > 1


def test_watchdog_aborts_stalled_loop():
    """A scheduler that refuses to schedule trips the watchdog: FAILED,
    the stream ends, the pages return."""
    jm, tm = models(213)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=1)
    rid = port.submit(R.randint(0, 97, (5,)), 6, stream=True)
    port._schedule = types.MethodType(lambda self: ([], 0, 0), port)
    with pytest.raises(EngineStallError):
        port.run(max_stall_s=0.1)
    assert port.request_stats[rid].status == RequestStatus.FAILED
    assert port.stream(rid).get(timeout=1) is None
    assert port.pool.pages_in_use == port.prefix.cached_pages


def test_replay_from_dumped_plan_is_identical():
    jm, tm = models(214)
    sub = [(R.randint(0, 97, (n,)), 6, {}) for n in (5, 9, 4)]
    kw = dict(page_size=PAGE, max_batch=2, retry_budget=10,
              async_dispatch=True)

    def drive(plan):
        eng, _ = engines(jm, tm, chaos=plan, **kw)
        out = serve(eng, sub)
        return out, [s.status for s in eng.request_stats.values()], eng

    plan = FaultPlan.random(31, steps=40, p_pool_alloc=0.08,
                            p_dispatch=0.08, p_fetch=0.08,
                            p_pool_spike=0.08)
    out1, st1, e1 = drive(plan)
    assert plan.fired_log()
    replayed = FaultPlan.from_dict(plan.to_dict())
    out2, st2, e2 = drive(replayed)
    assert replayed.fired_log() == plan.fired_log() and st1 == st2
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    assert books(e1) == books(e2)


def test_chaos_none_equals_empty_plan():
    jm, tm = models(215)
    sub = [(R.randint(0, 97, (n,)), 5, {}) for n in (5, 11, 4)]
    e0, _ = engines(jm, tm, page_size=PAGE, max_batch=2)
    e1, _ = engines(jm, tm, page_size=PAGE, max_batch=2, chaos=FaultPlan([]))
    for a, b in zip(serve(e0, sub), serve(e1, sub)):
        np.testing.assert_array_equal(a, b)
    assert books(e0) == books(e1)
    assert e1.executable_count == e0.executable_count
    assert e1.stats.step_failures == 0 and e1.chaos_fired == 0


@pytest.mark.parametrize("phase", ["dispatch", "fetch"])
def test_cuda_error_is_not_contained(phase, monkeypatch):
    """A kernel wrapper's launch failure is not a contained fault: it
    propagates out of run() uncounted (no failure, no retry), the stream
    still ends, and -- raised in the launch -- the host state is rolled
    back to before the step."""
    jm, tm = models(222)
    port, _ = engines(jm, tm, page_size=PAGE, max_batch=1,
                      async_dispatch=True)
    rid = port.submit(R.randint(0, 97, (5,)), 8, stream=True)
    port.step()
    port.step()
    err = RuntimeError("paged_ragged_attention kernel launch failed: "
                       "cudaError 700 (an illegal memory access was "
                       "encountered)")

    def boom(*a, **kw):
        raise err

    if phase == "dispatch":
        slot = port._slots[0]
        before = (slot.length, len(slot.pages), slot.inflight_emits)
        monkeypatch.setattr(engine_mod, "paged_ragged_attention", boom)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            port._dispatch(*port._schedule())
        assert (slot.length, len(slot.pages), slot.inflight_emits) == before
    else:
        port._fetch = types.MethodType(lambda self, inf: boom(), port)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        port.run()
    assert port.stats.step_failures == 0 and port.stats.retries_total == 0
    assert len(drain_stream(port.stream(rid))) < 8


# ---------------------------------------------------------------------------
# the property suite
# ---------------------------------------------------------------------------
N_SEEDS = 8


def _workload(rs, variant):
    """Nine requests: mixed lengths, a third sampled (not on spec
    engines), mixed priorities; the last two are priority-5 arrivals big
    enough to preempt on the tight pool."""
    workload = []
    for j in range(9):
        p = rs.randint(0, 97, (int(rs.randint(3, 15)),))
        n = int(rs.randint(3, 7))
        skw = {}
        if j % 3 == 2 and variant != 1:
            skw = dict(temperature=0.8, top_k=12,
                       seed=int(rs.randint(0, 2 ** 31)))
        if j >= 7:
            p = rs.randint(0, 97, (int(rs.randint(10, 15)),))
            n = 6
            skw = {}
        prio = 5 if j >= 7 else int(rs.randint(0, 3))
        workload.append((p, n, dict(skw, priority=prio)))
    late = [(int(rs.randint(4, 9)), 7), (int(rs.randint(9, 16)), 8)]
    return workload, late


def _drive(eng, workload, late, cancel_at):
    """Submit (late arrivals by iteration), cancel on schedule, step to
    drain; ``{request index: output}``."""
    late_j = {j for _, j in late}
    rids = {j: eng.submit(p, n, **skw)
            for j, (p, n, skw) in enumerate(workload) if j not in late_j}
    pending_late = sorted(late)
    it = 0
    while (pending_late or eng._queue or eng.active
           or eng._inflight is not None):
        it += 1
        assert it < 600, "chaos run did not drain"
        while pending_late and it >= pending_late[0][0]:
            _, j = pending_late.pop(0)
            p, n, skw = workload[j]
            rids[j] = eng.submit(p, n, **skw)
        eng.step()
        for at, victim in cancel_at:
            if it == at:
                eng.cancel(rids[victim])
    eng._release_spikes()
    if eng.sanitizer is not None:
        eng.sanitizer.check_drain(eng.prefix.pages())
        eng.sanitizer.verify_pool()
    return rids, {j: np.asarray(eng._results[r]) for j, r in rids.items()}


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_chaos_property_suite_matches_jax(seed):
    """A seeded random plan over a sync (seed % 3 == 2), async (0) or
    spec (1) engine on a tight pool: port and JAX engine under the same
    plan fire the same events and end with the same tokens, statuses,
    counters and books; the port's shadow books equal its pool's at every
    reconcile; every OK request equals the fault-free run and every other
    one's tokens are a prefix of it."""
    jm, tm = models(216)
    rs = np.random.RandomState(1000 + seed)
    variant = seed % 3
    kw = dict(page_size=8, max_batch=3, chunk_size=8, retry_budget=12,
              num_pages=1 + 6)
    if variant == 0:
        kw["async_dispatch"] = True
    elif variant == 1:
        kw.update(spec_decode="ngram", spec_k=3)
    workload, late = _workload(rs, variant)
    cancel_at = [(int(rs.randint(2, 12)), 0), (int(rs.randint(3, 20)), 4)]
    clean, _ = engines(jm, tm, **kw)
    _, ref_out = _drive(clean, workload, late, [])
    rates = dict(steps=60, p_pool_alloc=0.05, p_dispatch=0.05, p_fetch=0.05,
                 p_fetch_delay=0.02, p_pool_spike=0.05, delay_s=0.0005)
    pp, jp = FaultPlan.random(seed, **rates), JaxFaultPlan.random(seed,
                                                                  **rates)
    port, ref = _armed(jm, tm, pp, jp, **kw)
    reconcile = type(port)._reconcile

    def rec(self, inf, finished):
        reconcile(self, inf, finished)
        assert self.sanitizer.shadow_stats() == self.pool.stats()

    port._reconcile = types.MethodType(rec, port)
    rids, got = _drive(port, workload, late, cancel_at)
    _, want = _drive(ref, workload, late, cancel_at)
    assert pp.fired_log() == jp.fired_log()
    order = sorted(got)
    assert_same(port, [got[j] for j in order], ref,
                [want[j] for j in order])
    for j, rid in rids.items():
        status = port.request_stats[rid].status
        full = ref_out[j]
        if status == RequestStatus.OK:
            np.testing.assert_array_equal(got[j], full,
                                          err_msg=f"seed {seed} req {j}")
        else:
            np.testing.assert_array_equal(got[j], full[:len(got[j])])
    assert len(rids) == len(workload)
