"""The port's page sanitizer (``paddle_ray_tpu_torch/serving/pagesan.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_pagesan.py``: every lifecycle fault the sanitizer
exists for is injected into a port pool and a JAX pool alike, and both
must raise ``PageSanError`` with the same message; seeded adversarial
alloc / free / incref / decref / write / copy-on-write / rollback
interleavings must leave the port's shadow books equal to the JAX
sanitizer's and to each pool's own stats after every operation; and the
engine-level injected bugs (a leak, a stale table, a missing rollback, a
phantom dispatch) surface through the port engine's ``run()`` as through
the JAX engine's.  The engines run the small GPT of
``torch_serving_pair``."""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.serving import PagePool as JaxPagePool
from paddle_ray_tpu.serving import PageSanError as JaxPageSanError
from paddle_ray_tpu.serving import PageSanitizer as JaxPageSanitizer
from paddle_ray_tpu_torch.serving import PagePool, PageSanError, PageSanitizer
# one_torch_thread: an autouse fixture, in force once imported
from torch_serving_pair import (PAGE, books, engines, models,
                                one_torch_thread)

R = np.random.RandomState(0)


def _pools(num_pages=9, page=4):
    """(port pool + sanitizer, JAX pool + sanitizer)."""
    port = PagePool(1, num_pages, page, 1, 8, dtype=torch.float32,
                    device="cpu")
    ref = JaxPagePool(1, num_pages, page, 1, 8, dtype=jnp.float32)
    return (port, PageSanitizer(port)), (ref, JaxPageSanitizer(ref))


def _double_free(pool, san):
    (p,) = pool.alloc(1)
    pool.decref(p)
    pool.decref(p)


def _double_strict_free(pool, san):
    (p,) = pool.alloc(1)
    pool.decref(p)
    pool.free([p])


def _free_while_shared(pool, san):
    (p,) = pool.alloc(1)
    pool.incref(p)
    pool.free([p])


def _incref_after_free(pool, san):
    (p,) = pool.alloc(1)
    pool.decref(p)
    pool.incref(p)


def _free_list_corruption(pool, san):
    (p,) = pool.alloc(1)
    pool._free.append(p)
    pool.alloc(1)


def _write_to_shared(pool, san):
    (p,) = pool.alloc(1)
    pool.incref(p)
    san.note_append("A", [p], 0, 2, pool.page_size)


def _use_after_free_gather(pool, san):
    (p,) = pool.alloc(1)
    san.note_append("A", [p], 0, 3, pool.page_size)
    san.note_gather("A", [p])
    pool.decref(p)
    san.note_gather("A", [p])


def _stale_kv(pool, san):
    (a,) = pool.alloc(1)
    san.note_append("A", [a], 0, 3, pool.page_size)
    pool.decref(a)
    (b,) = pool.alloc(1)
    assert b == a                      # LIFO recycling: the same page
    san.note_append("B", [b], 0, 2, pool.page_size)
    san.note_gather("A", [a])


def _unmapped_gather(pool, san):
    (p,) = pool.alloc(1)
    san.note_gather("A", [p])


def _cow_freed_source(pool, san):
    src, dst = pool.alloc(2)
    pool.decref(src)
    san.note_copy("A", src, dst, 2)


def _cow_shared_target(pool, san):
    src, dst = pool.alloc(2)
    pool.incref(dst)
    san.note_copy("A", src, dst, 2)


def _missing_rollback(pool, san):
    (p,) = pool.alloc(1)
    page = pool.page_size
    san.note_append("A", [p], 0, 3, page)
    san.note_rollback("A", [p], 1, 3, page)   # legal retreat
    san.note_append("A", [p], 1, 3, page)
    san.note_gather("A", [p])
    san.note_append("A", [p], 2, 4, page)     # rewind without rollback


def _gather_rolled_back_page(pool, san):
    a, b = pool.alloc(2)
    page = pool.page_size
    san.note_append("A", [a, b], 0, 6, page)
    san.note_rollback("A", [a, b], 3, 6, page)
    san.note_gather("A", [a])
    san.note_gather("A", [b])


def _rollback_freed(pool, san):
    (p,) = pool.alloc(1)
    san.note_append("A", [p], 0, 2, pool.page_size)
    pool.decref(p)
    san.note_rollback("A", [p], 0, 2, pool.page_size)


def _share_after_free(pool, san):
    (p,) = pool.alloc(1)
    pool.decref(p)
    san.note_share("A", p)


def _leak(pool, san):
    pool.alloc(1)
    san.check_drain(())


def _out_of_order(pool, san):
    san.note_defer(1)
    san.note_defer(2)
    san.note_reconcile(2)


def _never_deferred(pool, san):
    san.note_reconcile(7)


def _deferred_twice(pool, san):
    san.note_defer(3)
    san.note_defer(3)


def _double_reconcile(pool, san):
    san.note_defer(3)
    san.note_reconcile(3)
    san.note_reconcile(3)


def _dropped_commit(pool, san):
    san.note_defer(5)
    san.check_drain(())


def _abort_out_of_order(pool, san):
    san.note_defer(1)
    san.note_defer(2)
    san.note_abort(2)


FAULTS = {
    "double_free": (_double_free, "double free"),
    "double_strict_free": (_double_strict_free, "double free"),
    "free_while_shared": (_free_while_shared, "shared"),
    "incref_after_free": (_incref_after_free, "use-after-free"),
    "free_list_corruption": (_free_list_corruption, "free-list corruption"),
    "write_to_shared": (_write_to_shared, "SHARED"),
    "use_after_free_gather": (_use_after_free_gather,
                              "use-after-free gather"),
    "stale_kv": (_stale_kv, "stale-KV"),
    "unmapped_gather": (_unmapped_gather, "unmapped"),
    "cow_freed_source": (_cow_freed_source, "freed source"),
    "cow_shared_target": (_cow_shared_target, "exclusive"),
    "missing_rollback": (_missing_rollback, "without a rollback"),
    "gather_rolled_back_page": (_gather_rolled_back_page, "unmapped"),
    "rollback_freed": (_rollback_freed, "use-after-free"),
    "share_after_free": (_share_after_free, "share of freed"),
    "leak": (_leak, "leaked"),
    "out_of_order_reconcile": (_out_of_order, "out-of-order"),
    "reconcile_never_deferred": (_never_deferred, "never deferred"),
    "deferred_twice": (_deferred_twice, "deferred twice"),
    "double_reconcile": (_double_reconcile, "never deferred"),
    "dropped_commit": (_dropped_commit, "never reconciled"),
    "abort_out_of_order": (_abort_out_of_order, "out-of-order"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_injected_fault_raises_like_jax(fault):
    """Each injected lifecycle fault raises ``PageSanError`` in the port as
    in the JAX package, with the same message."""
    fn, match = FAULTS[fault]
    (pool, san), (jpool, jsan) = _pools()
    with pytest.raises(PageSanError, match=match) as got:
        fn(pool, san)
    with pytest.raises(JaxPageSanError, match=match) as want:
        fn(jpool, jsan)
    assert str(got.value) == str(want.value)
    assert san.events == jsan.events


def test_legal_sequences_stay_quiet():
    """In-order defer/reconcile/abort, a rollback then a legal re-append,
    and a held page at drain raise nothing."""
    (pool, san), _ = _pools()
    san.note_defer(1)
    san.note_defer(2)
    san.note_abort(1)
    san.note_reconcile(2)
    (p,) = pool.alloc(1)
    san.note_append("A", [p], 0, 3, pool.page_size)
    san.note_rollback("A", [p], 1, 3, pool.page_size)
    san.note_append("A", [p], 1, 3, pool.page_size)
    san.note_gather("A", [p])
    san.check_drain([p])
    san.verify_pool()
    san.detach()
    assert pool.alloc == PagePool.alloc.__get__(pool)


def test_shadow_books_equal_jax_under_adversarial_interleavings():
    """Seeded alloc / incref / decref / free / copy-on-write / rewrite /
    draft-rollback interleavings, applied to a port pool and a JAX pool:
    after every operation the port's shadow stats equal its pool's stats
    and the JAX sanitizer's shadow stats, field for field."""
    rng = np.random.RandomState(1234)
    port = PagePool(2, 17, 8, 2, 16, dtype=torch.float32, device="cpu")
    ref = JaxPagePool(2, 17, 8, 2, 16, dtype=jnp.float32)
    san, jsan = PageSanitizer(port), JaxPageSanitizer(ref)
    page = port.page_size
    refs = []

    def both(fn):
        a, b = fn(port, san), fn(ref, jsan)
        assert a == b
        return a

    def check():
        tokens = san.live_rows()
        assert tokens == jsan.live_rows()
        shadow = san.shadow_stats(live_tokens=tokens)
        assert shadow == port.stats(live_tokens=tokens)
        assert shadow == jsan.shadow_stats(live_tokens=tokens)
        san.verify_pool()
        assert san.shared_bytes() == jsan.shared_bytes()
        assert san.snapshot() == jsan.snapshot()

    for step in range(400):
        op = rng.randint(7)
        exclusive = [p for p in set(refs) if refs.count(p) == 1]
        if op == 0 and port.num_free > 0:
            n = rng.randint(1, min(3, port.num_free) + 1)
            pages = both(lambda p, s: p.alloc(n))
            refs.extend(pages)
            for pg in pages:
                rows = int(rng.randint(0, page + 1))
                if rows:
                    both(lambda p, s: (s.note_append(f"s{step}", [pg], 0,
                                                     rows, page),
                                       s.note_gather(f"s{step}", [pg])))
        elif op == 1 and refs:
            pg = refs[rng.randint(len(refs))]
            both(lambda p, s: (p.incref(pg), s.note_share(f"r{step}", pg)))
            refs.append(pg)
        elif op == 2 and refs:
            pg = refs.pop(rng.randint(len(refs)))
            both(lambda p, s: p.decref(pg))
        elif op == 3 and exclusive:
            pg = exclusive[rng.randint(len(exclusive))]
            both(lambda p, s: p.free([pg]))
            refs.remove(pg)
        elif op == 4 and exclusive and port.num_free > 0:
            src = exclusive[rng.randint(len(exclusive))]
            rows = int(rng.randint(1, page + 1))

            def cow(p, s):
                p.incref(src)
                (dst,) = p.alloc(1)
                s.note_copy(f"c{step}", src, dst, rows)
                p.decref(src)
                return dst
            refs.append(both(cow))
        elif op == 5 and exclusive:
            pg = exclusive[rng.randint(len(exclusive))]
            rows = int(rng.randint(1, page + 1))
            both(lambda p, s: (s.note_append(f"w{step}", [pg], 0, rows,
                                             page),
                               s.note_gather(f"w{step}", [pg])))
        elif op == 6 and exclusive:
            pg = exclusive[rng.randint(len(exclusive))]
            r1 = int(rng.randint(2, page + 1))
            r2 = int(rng.randint(0, r1))

            def draft(p, s):
                s.note_append(f"rb{step}", [pg], 0, r1, page)
                s.note_rollback(f"rb{step}", [pg], r2, r1, page)
                if r2:
                    s.note_gather(f"rb{step}", [pg])
                    s.note_append(f"rb{step}", [pg], r2, r1, page)
            both(draft)
        check()
    assert port.peak_pages_in_use > 0
    for pg in list(refs):
        both(lambda p, s: p.decref(pg))
        refs.remove(pg)
    check()
    san.check_drain(())
    assert port.stats()["live"] == 0


# ---------------------------------------------------------------------------
# engine integration: injected scheduler bugs surface through run()
# ---------------------------------------------------------------------------
class _WrongDrafter:
    """Always proposes 1..k: every verify step rejects every draft."""

    def register(self, rid, prompt):
        pass

    def observe(self, rid, tokens):
        pass

    def release(self, rid):
        pass

    def propose(self, rid, k):
        return np.arange(1, k + 1, dtype=np.int32)


def _leak_after_drain(eng):
    eng.submit(R.randint(0, 97, (5,)), 3)
    eng.run()                          # clean: drains with zero pages
    eng.pool.alloc(1)                  # injected: a page leaves the books
    eng.run()


def _stale_table(eng):
    eng.submit(R.randint(0, 97, (20,)), 6)
    eng.step()                         # prefill (2 pages) + first token
    p0 = eng._slots[0].pages[0]        # a full page decode only reads
    eng.pool.decref(p0)                # injected: freed under the mapping
    eng.pool.alloc(1)                  # recycled by "someone else"
    eng.run()


def _missing_engine_rollback(eng):
    eng._rollback = lambda *a, **kw: None
    eng.submit(R.randint(0, 97, (5,)), 10)
    eng.run()


def _phantom_dispatch(eng):
    eng.sanitizer.note_defer(999)      # a dropped commit
    eng.submit(R.randint(0, 97, (5,)), 4)
    eng.run()


ENGINE_FAULTS = {
    "leak_at_drain": (_leak_after_drain, {}, "leaked"),
    "stale_table": (_stale_table, {}, "stale-KV"),
    "missing_rollback": (_missing_engine_rollback,
                         dict(spec_k=4), "without a rollback"),
    "phantom_dispatch": (_phantom_dispatch, dict(async_dispatch=True),
                         "out-of-order"),
}


@pytest.mark.parametrize("fault", sorted(ENGINE_FAULTS))
def test_engine_fault_detected_like_jax(fault):
    """The same injected engine bug raises in the port's engine and the
    JAX engine, with the same message."""
    fn, kw, match = ENGINE_FAULTS[fault]
    jm, tm = models(80)
    kw = dict(kw, page_size=PAGE, max_batch=1, prefix_cache=False)
    if "spec_k" in kw:
        kw["spec_decode"] = _WrongDrafter()
    port, ref = engines(jm, tm, **kw)
    state = R.get_state()
    with pytest.raises(PageSanError, match=match) as got:
        fn(port)
    R.set_state(state)
    with pytest.raises(JaxPageSanError, match=match) as want:
        fn(ref)
    # messages name pages and epochs, which agree when the books do
    assert re.sub(r"\s+", " ", str(got.value)) == \
        re.sub(r"\s+", " ", str(want.value))


def test_engine_clean_run_books_equal_jax():
    """No false positive on a correct engine, and its books equal the JAX
    engine's after each drain of prefix-cache traffic (shares and a
    copy-on-write)."""
    jm, tm = models(82)
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2, chunk_size=16)
    prefix = R.randint(0, 97, (37,))
    waves = [[np.concatenate([prefix, R.randint(0, 97, (5,))])],
             [np.concatenate([prefix, R.randint(0, 97, (3,))]),
              R.randint(0, 97, (11,))]]
    for wave in waves:
        for eng in (port, ref):
            rids = [eng.submit(p, 4) for p in wave]
            eng.run()
        assert [port._results[r].tolist() for r in rids] == \
            [np.asarray(ref._results[r]).tolist() for r in rids]
        assert books(port) == books(ref)
    assert port.sanitizer.events > 0
    st = port.pool_stats()
    assert st["live"] == port.sanitizer.live_pages
    assert st["shared"] == port.sanitizer.shared_pages
    assert port.stats.prefix_hit_tokens == ref.stats.prefix_hit_tokens > 0
