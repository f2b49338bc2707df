"""The port's speculative decoding against the JAX engine's, on the CPU.

Mirrors ``tests/test_spec_decode.py``: the n-gram drafter and the greedy
accept rule against the JAX package's; the spec step
(``_mixed_step_spec``: the LM head over every chunk row, row argmax plus
each slot's last-row token, the ``use_prev`` gather) against the JAX
step on the same inputs; and the spec engine against the JAX spec engine
on the same workloads -- n-gram drafts at k 1 / 2 / 4, verify chunks
beside prefill chunks and a dead slot, always-rejected and
always-accepted drafts, eos inside an accepted run, a pinned token
budget, a pool sized for one request -- with exact tokens, schedule
counters (drafts, accepted, steps), pool and pagesan books, and the
tokens of the spec-off engine.  Every engine runs ``sanitize=True``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.serving import NGramDrafter as JaxNGramDrafter
from paddle_ray_tpu.serving import greedy_accept as jax_greedy_accept
from paddle_ray_tpu.serving.engine import _mixed_step_spec as jax_step_spec
from paddle_ray_tpu_torch.serving import NGramDrafter, greedy_accept
from paddle_ray_tpu_torch.serving.engine import _mixed_step_spec
# one_torch_thread: an autouse fixture, in force once imported
from torch_serving_pair import (PAGE, assert_same, engines, models,
                                one_torch_thread, pair, serve)

R = np.random.RandomState(0)


class OracleDrafter:
    """Proposes the true greedy continuation (from a reference run),
    optionally shifted: offset 0 is always-accept, otherwise
    always-reject-first."""

    def __init__(self, refs, vocab, offset=0):
        self.refs = {}
        self._queue = list(refs)       # dealt to rids in submit order
        self.vocab = vocab
        self.offset = offset
        self._out = {}

    def register(self, rid, prompt):
        self.refs[rid] = np.asarray(self._queue.pop(0))
        self._out[rid] = 0

    def observe(self, rid, tokens):
        self._out[rid] += len(tokens)

    def propose(self, rid, k):
        ref, done = self.refs[rid], self._out[rid]
        return (ref[done:done + k] + self.offset) % self.vocab

    def release(self, rid):
        self._out.pop(rid, None)


def _greedy_refs(tm, prompts, news, **kw):
    """Spec-off greedy outputs of the port engine (itself held to the JAX
    engine by ``test_torch_serving.py``)."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    eng = ServingEngine(tm, device="cpu", page_size=PAGE, max_batch=4,
                        chunk_size=32, **kw)
    return serve(eng, [(p, n, {}) for p, n in zip(prompts, news)])


# ---------------------------------------------------------------------------
# drafter and accept rule
# ---------------------------------------------------------------------------
def test_ngram_drafter_cases_match_jax():
    """Hit, miss, a continuation past the first period, observe/release,
    a periodic tail tiled out to k, k = 0: the port's proposals equal the
    JAX drafter's and the expected tokens."""
    cases = [
        ([1, 2, 5, 6, 7, 8, 9, 3, 5, 6], 3, [7, 8, 9]),
        ([1, 2, 3, 4, 5], 3, []),
        ([9, 1, 2, 7, 8, 9, 1, 2], 4, [7, 8, 9, 1]),
        ([4, 5, 6] * 4, 5, [4, 5, 6, 4, 5]),
        ([1, 2, 20, 20, 20, 20], 4, [20, 20, 20, 20]),
        ([1, 2, 3, 1, 2], 0, []),
    ]
    for d in (NGramDrafter(max_ngram=3), JaxNGramDrafter(max_ngram=3)):
        for rid, (hist, k, want) in enumerate(cases):
            d.register(rid, hist)
            np.testing.assert_array_equal(d.propose(rid, k), want)
        d.observe(1, [1, 2, 3])            # history ...4, 5, 1, 2, 3
        np.testing.assert_array_equal(d.propose(1, 2), [4, 5])
        d.release(1)
        assert d.history_len(1) == 0 and len(d.propose(1, 2)) == 0
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=2, min_ngram=3)


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (4, 2)])
def test_ngram_drafter_random_histories_match_jax(max_ngram, min_ngram):
    """Random low-entropy histories grown token by token: every proposal
    (k 1-6) and the counters equal the JAX drafter's."""
    rng = np.random.RandomState(max_ngram)
    port = NGramDrafter(max_ngram, min_ngram)
    ref = JaxNGramDrafter(max_ngram, min_ngram)
    for rid in range(6):
        prompt = rng.randint(0, 5, (int(rng.randint(1, 12)),))
        for d in (port, ref):
            d.register(rid, prompt)
        for _ in range(30):
            k = int(rng.randint(1, 7))
            np.testing.assert_array_equal(port.propose(rid, k),
                                          ref.propose(rid, k))
            toks = rng.randint(0, 5, (int(rng.randint(1, 4)),)).tolist()
            port.observe(rid, toks)
            ref.observe(rid, toks)
    assert (port.proposals, port.empty_proposals, port.proposed_tokens) \
        == (ref.proposals, ref.empty_proposals, ref.proposed_tokens)


def test_greedy_accept_matches_jax():
    """The prefix rule's cases and 200 random drafts: the port's
    ``(accepted, emitted)`` equal the JAX function's."""
    rows = np.asarray([10, 11, 12, 13, 14])
    for draft, row, acc_want, em_want in (
            ([10, 11, 12, 13], rows, 4, rows),
            ([10, 11, 99, 13], rows, 2, [10, 11, 12]),
            ([99], rows[:2], 0, [10]),
            ([], rows[:1], 0, [10])):
        acc, em = greedy_accept(draft, row)
        assert acc == acc_want and em.dtype == np.int32
        np.testing.assert_array_equal(em, em_want)
    with pytest.raises(ValueError):
        greedy_accept([1, 2], [3, 4])
    rng = np.random.RandomState(2)
    for _ in range(200):
        k = int(rng.randint(0, 6))
        row = rng.randint(0, 3, (k + 1 + int(rng.randint(0, 2)),))
        draft = rng.randint(0, 3, (k,))
        a, ea = greedy_accept(draft, row)
        b, eb = jax_greedy_accept(draft, row)
        assert a == b
        np.testing.assert_array_equal(ea, eb)


# ---------------------------------------------------------------------------
# the spec step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampled", [False, True])
def test_spec_step_matches_jax(sampled):
    """One spec step over a width-8 chunk set -- verify lanes of 5 and 3
    rows, a 1-row decode lane whose column 0 comes from ``use_prev``, a
    prefill chunk and a dead slot -- on the port and the JAX step from the
    same pool: equal row argmax and last-row tokens, and the pools equal
    to float32 rounding."""
    jm, tm = models(70)
    s, w, p = 5, 8, 4
    n_pages = 1 + s * p
    cfg = tm.cfg
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(5)
    table = np.zeros((s, p), np.int32)
    table[:4] = (1 + rng.permutation(n_pages - 1)[:16]).reshape(4, p)
    q_lens = np.asarray([5, 3, 1, 8, 0], np.int32)
    starts = np.asarray([20, 33, 9, 0, 0], np.int32)
    lengths = np.where(q_lens > 0, starts + q_lens, 0).astype(np.int32)
    toks = rng.randint(0, 97, (s, w)).astype(np.int32)
    positions = (starts[:, None] + np.arange(w)[None]).astype(np.int32)
    prev = rng.randint(0, 97, (s,)).astype(np.int32)
    use_prev = np.asarray([False, False, True, False, False])
    temps = np.asarray([0, 0, 0.9 if sampled else 0, 0, 0], np.float32)
    top_ks = np.asarray([0, 0, 8, 0, 0], np.int32)
    top_ps = np.ones((s,), np.float32)
    seeds = np.arange(s, dtype=np.uint32) + 7
    pool = rng.randn(cfg.num_layers, n_pages, PAGE, h, d).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pools = (t(pool.copy()), t(pool.copy()))
    sampling = ((t(temps), t(top_ks), t(top_ps), t(seeds.astype(np.int64)))
                if sampled else None)
    with torch.no_grad():
        pools, rows, last = _mixed_step_spec(
            tm, t(toks), t(positions), t(q_lens), t(lengths), t(table),
            pools, t(prev), t(use_prev), sampling, lengths.tolist())
    jpools, jrows, jlast = jax_step_spec(
        jm, jnp.asarray(toks), jnp.asarray(positions), jnp.asarray(q_lens),
        jnp.asarray(lengths), jnp.asarray(table),
        (jnp.asarray(pool), jnp.asarray(pool)), jnp.asarray(prev),
        jnp.asarray(use_prev), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), jnp.asarray(seeds), interpret=True)
    valid = np.arange(w)[None] < q_lens[:, None]
    np.testing.assert_array_equal(np.where(valid, rows.numpy(), 0),
                                  np.where(valid, np.asarray(jrows), 0))
    live = q_lens > 0
    np.testing.assert_array_equal(last.numpy()[live],
                                  np.asarray(jlast)[live])
    for a, b in zip(pools, jpools):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_all_logits_step_matches_jax():
    """``paged_mixed_step(all_logits=True)``: every chunk row's logits equal
    the JAX step's within float32 rounding (a verify lane, a prefill chunk,
    a decode row, a dead slot)."""
    from paddle_ray_tpu.serving.engine import (paged_mixed_step as
                                               jax_mixed_step)
    from paddle_ray_tpu_torch.serving.engine import paged_mixed_step
    jm, tm = models(73)
    cfg = tm.cfg
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(9)
    s, w, p = 4, 8, 4
    n_pages = 1 + s * p
    table = (1 + rng.permutation(n_pages - 1)).reshape(s, p)
    table[3] = 0
    table = table.astype(np.int32)
    q_lens = np.asarray([5, 8, 1, 0], np.int32)
    starts = np.asarray([30, 0, 17, 0], np.int32)
    lengths = np.where(q_lens > 0, starts + q_lens, 0).astype(np.int32)
    toks = rng.randint(0, 97, (s, w)).astype(np.int32)
    positions = (starts[:, None] + np.arange(w)[None]).astype(np.int32)
    pool = rng.randn(cfg.num_layers, n_pages, PAGE, h, d).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    with torch.no_grad():
        _, got = paged_mixed_step(tm, t(toks), t(positions), t(q_lens),
                                  t(lengths), t(table),
                                  (t(pool.copy()), t(pool.copy())),
                                  all_logits=True)
    _, want = jax_mixed_step(jm, jnp.asarray(toks), jnp.asarray(positions),
                             jnp.asarray(q_lens), jnp.asarray(lengths),
                             jnp.asarray(table),
                             (jnp.asarray(pool), jnp.asarray(pool)),
                             all_logits=True, interpret=True)
    assert got.shape == (s, w, 97)
    valid = np.arange(w)[None] < q_lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the spec engine against the JAX spec engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_engine_matches_jax_and_greedy(k):
    """n-gram speculation at k on a mixed batch: tokens, counters and
    books equal the JAX spec engine's, tokens equal the spec-off run."""
    jm, tm = models(70)
    prompts = [R.randint(0, 97, (n,)) for n in (5, 11, 3, 17)]
    news = [14, 12, 16, 10]
    port, got = pair(jm, tm, [(p, n, {}) for p, n in zip(prompts, news)],
                     page_size=PAGE, max_batch=3, chunk_size=16,
                     spec_decode="ngram", spec_k=k)
    for a, b in zip(got, _greedy_refs(tm, prompts, news)):
        np.testing.assert_array_equal(a, b)
    assert port.stats.draft_tokens > 0, "workload never speculated"


def test_spec_mixed_prefill_decode_dead_slots():
    """A long prompt submitted mid-decode: verify chunks share steps with
    its prefill chunks while a dead slot rides along."""
    jm, tm = models(71)
    p1, p2, p3 = (R.randint(0, 97, (n,)) for n in (4, 6, 45))
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=4, chunk_size=16,
                        spec_decode="ngram", spec_k=4)
    outs = []
    for eng in (port, ref):
        r1, r2 = eng.submit(p1, 16), eng.submit(p2, 14)
        for _ in range(4):
            eng.step()
        r3 = eng.submit(p3, 6)
        out = eng.run()
        outs.append([np.asarray(out[r]) for r in (r1, r2, r3)])
    assert_same(port, outs[0], ref, outs[1])
    for a, b in zip(outs[0], _greedy_refs(tm, [p1, p2, p3], [16, 14, 6])):
        np.testing.assert_array_equal(a, b)
    assert port.stats.draft_tokens > 0 and port.stats.prefill_tokens >= 45


@pytest.mark.parametrize("offset", [1, 0], ids=["reject", "accept"])
def test_oracle_drafts_match_jax(offset):
    """Always-wrong drafts: every verify rejects every draft, rolls back,
    one token per slot per step, the pool drains to zero.  Always-right
    drafts: a step commits k + 1 tokens and the step count collapses."""
    jm, tm = models(72)
    prompts = [R.randint(0, 97, (n,)) for n in (5, 9)]
    n, k = 21, 4
    refs = _greedy_refs(tm, prompts, [n, n])
    kw = dict(page_size=PAGE, max_batch=2, prefix_cache=False, spec_k=k)
    port, ref = engines(jm, tm, **kw)
    port.spec = OracleDrafter(refs, 97, offset)
    ref.spec = OracleDrafter(refs, 97, offset)
    sub = [(p, n, {}) for p in prompts]
    got, want = serve(port, sub), serve(ref, sub)
    assert_same(port, got, ref, want)
    for a, b in zip(got, refs):
        np.testing.assert_array_equal(a, b)
    st = port.stats
    assert st.draft_tokens > 0
    if offset:
        assert st.accepted_tokens == 0
        assert st.decode_tokens == sum(len(r) - 1 for r in refs)
    else:
        assert st.accepted_tokens == st.draft_tokens
        assert st.mixed_steps <= 1 + -(-(n - 1) // (k + 1)) + 1
        assert all(r.acceptance_rate == 1.0
                   for r in port.request_stats.values())
    assert port.pool.pages_in_use == 0, "rollback leaked pages"


def test_spec_eos_truncates_like_jax():
    """eos inside an accepted run: emission stops at the eos as
    token-by-token decoding would."""
    jm, tm = models(74)
    p = R.randint(0, 97, (6,))
    (full,) = _greedy_refs(tm, [p], [20])
    eos = int(full[6])
    want = full[:int(np.nonzero(full == eos)[0][0]) + 1]
    port, (got,) = pair(jm, tm, [(p, 20, {})], page_size=PAGE, max_batch=1,
                        eos_token_id=eos, spec_decode="ngram", spec_k=4)
    np.testing.assert_array_equal(got, want)
    assert port.pool.pages_in_use == port.prefix.cached_pages


def test_spec_respects_token_budget():
    """Budget pinned to max_batch + 1: at most one draft row a step in
    total, still exact and progressing."""
    jm, tm = models(78)
    prompts = [R.randint(0, 97, (n,)) for n in (5, 7)]
    port, got = pair(jm, tm, [(p, 10, {}) for p in prompts],
                     page_size=PAGE, max_batch=2, chunk_size=16,
                     token_budget=3, spec_decode="ngram", spec_k=4)
    for a, b in zip(got, _greedy_refs(tm, prompts, [10, 10])):
        np.testing.assert_array_equal(a, b)
    assert max(port.stats.decode_step_width) <= 10


def test_rollback_keeps_pool_exact_on_tight_pool():
    """A pool sized for one request's worst case: draft appends borrow
    pages, rejections return them, and a queued second request still
    admits; allocation churn equals the JAX engine's."""
    jm, tm = models(79)
    p1, p2 = R.randint(0, 97, (9,)), R.randint(0, 97, (5,))
    refs = _greedy_refs(tm, [p1, p2], [8, 8])
    page = 8
    need = -(-(9 + 8) // page)
    kw = dict(page_size=page, max_batch=1, prefix_cache=False,
              num_pages=1 + need, chunk_size=16, spec_k=4)
    port, ref = engines(jm, tm, **kw)
    port.spec = OracleDrafter(refs, 97, offset=1)
    ref.spec = OracleDrafter(refs, 97, offset=1)
    sub = [(p1, 8, {}), (p2, 8, {})]
    got, want = serve(port, sub), serve(ref, sub)
    assert_same(port, got, ref, want)
    st = port.pool.stats()
    assert st["allocated_total"] == st["freed_total"] > 2 * need


def test_spec_validation_matches_jax():
    from paddle_ray_tpu.serving import ServingEngine as JaxServingEngine
    from paddle_ray_tpu_torch.serving import ServingEngine
    jm, tm = models(76)
    for kw, match in ((dict(spec_decode="beam"), "spec_decode"),
                      (dict(spec_decode="ngram", spec_k=0), "spec_k"),
                      (dict(page_size=8, chunk_size=4, spec_decode="ngram",
                            spec_k=4), "executable family")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(tm, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxServingEngine(jm, **kw)


def test_spec_off_reports_zero_spec_stats():
    jm, tm = models(75)
    port, _ = pair(jm, tm, [(R.randint(0, 97, (5,)), 4, {})],
                   page_size=PAGE, max_batch=1)
    assert port.stats.draft_tokens == port.stats.accepted_tokens == 0
    assert port.stats.acceptance_rate == 0.0
    rst = port.request_stats[0]
    assert rst.draft_tokens == rst.accepted_tokens == 0


def test_spec_steady_state_width_family():
    """Three identical waves: the third runs no width the first two did
    not, the family stays within the budget (buckets + 1), and the
    executable count equals the JAX engine's."""
    jm, tm = models(77)
    prompts = [R.randint(0, 97, (n,)) for n in (5, 11, 3)]
    port, ref = engines(jm, tm, page_size=PAGE, max_batch=2,
                        spec_decode="ngram", spec_k=4)
    for wave in range(3):
        for eng in (port, ref):
            for p in prompts:
                eng.submit(p, 8)
            eng.run()
        if wave == 1:
            warm, rc = port.executable_count, port.recompiles
    assert port.executable_count == warm <= port.executable_budget
    assert port.recompiles == rc
    assert port.executable_count == ref.executable_count
