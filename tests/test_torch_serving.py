"""The port's ServingEngine against the JAX engine, on the CPU.

Both engines serve the same workload with the same weights (the JAX
model's state dict carried over by ``gpt_from_jax_state_dict``); greedy
tokens must be exactly equal, and so must the schedule (steps, prefill
and decode token counts, prefix hits).  Mirrors ``tests/test_serving.py``
and ``tests/test_prefix_cache.py``: chunked prefill under continuous
batching, prefix-cache hits with copy-on-write, eos retirement, page
recycling without stale KV, admission that waits for pool capacity, and
the pool's accounting.  The int8 KV pool must give the JAX engine's
tokens too.  Sampled requests (per-request temperature / top-k / top-p /
seed) must give the JAX engine's tokens up to the first position where
they differ, and there the top two perturbed logits must lie within 1e-5
(the frameworks' ``log`` may differ by an ulp, see ``core/prng.py``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.serving import PagePool as JaxPagePool
from paddle_ray_tpu.serving import ServingEngine as JaxServingEngine
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.serving import PagePool, ServingEngine
from paddle_ray_tpu_torch.weights import gpt_from_jax_state_dict

SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0, use_rotary=True)
SCHEDULE_KEYS = ("prefill_tokens", "padded_prefill_tokens", "decode_tokens",
                 "prefix_hit_tokens", "mixed_steps", "requests_finished",
                 "blocked_pool_pressure", "blocked_no_slot", "retries_total")


def _models(seed):
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**SHAPE))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax_state_dict(GPTConfig(**SHAPE), state,
                                       device="cpu")


def _serve(engine, prompts, news, serial=False, sampling=None):
    """Submit everything (or one request per drain) and run to drain;
    ``sampling`` gives each request's submit keywords."""
    rids, out = [], {}
    for i, (p, n) in enumerate(zip(prompts, news)):
        rids.append(engine.submit(p, n, **(sampling[i] if sampling else {})))
        if serial:
            out.update(engine.run())
    out.update(engine.run())
    return [np.asarray(out[r]) for r in rids]


def _assert_same(port_eng, port_out, jax_eng, jax_out):
    for i, (a, b) in enumerate(zip(port_out, jax_out)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    ps, js = port_eng.stats.to_dict(), jax_eng.stats.to_dict()
    assert sorted(ps) == sorted(js), "stats schema drifted"
    assert {k: ps[k] for k in SCHEDULE_KEYS} == \
        {k: js[k] for k in SCHEDULE_KEYS}


def _pair_run(jm, tm, prompts, news, serial=False, **kw):
    port = ServingEngine(tm, device="cpu", **kw)
    ref = JaxServingEngine(jm, **kw)
    port_out = _serve(port, prompts, news, serial)
    jax_out = _serve(ref, prompts, news, serial)
    _assert_same(port, port_out, ref, jax_out)
    return port, port_out


def test_continuous_batching_chunked_prefill_matches_jax():
    jm, tm = _models(60)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, 97, (n,)) for n in (5, 11, 3, 17, 9)]
    eng, _ = _pair_run(jm, tm, prompts, [4, 3, 5, 3, 4], page_size=8,
                       max_batch=3, chunk_size=8)
    # a drained engine holds only what the prefix cache keeps warm
    assert eng.pool.pages_in_use == eng.prefix.cached_pages
    eng.clear_prefix_cache()
    assert eng.pool.pages_in_use == 0


def test_prefix_hit_and_copy_on_write_match_cache_off_and_jax():
    jm, tm = _models(72)
    r = np.random.RandomState(1)
    prefix = r.randint(0, 97, (37,))
    prompts = [np.concatenate([prefix, r.randint(0, 97, (n,))])
               for n in (6, 9)]
    kw = dict(page_size=8, max_batch=1, chunk_size=8)
    eng, hot = _pair_run(jm, tm, prompts, [5, 5], serial=True, **kw)
    cold = _serve(ServingEngine(tm, device="cpu", prefix_cache=False, **kw),
                  prompts, [5, 5], serial=True)
    for a, b in zip(hot, cold):
        np.testing.assert_array_equal(a, b)
    # 4 full pages shared (32 tokens) + 5 copied rows = the whole prefix
    assert eng.request_stats[0].prefix_hit_tokens == 0
    assert eng.request_stats[1].prefix_hit_tokens == 37
    assert eng.prefix.hits == 1 and eng.prefix.misses == 1


def test_eos_retires_early_and_frees_pages():
    jm, tm = _models(65)
    p = np.random.RandomState(2).randint(0, 97, (6,))
    (ref,) = _serve(ServingEngine(tm, device="cpu", page_size=8,
                                  max_batch=1), [p], [10])
    eos = int(ref[2])                            # force an early stop
    eng, (out,) = _pair_run(jm, tm, [p], [10], page_size=8, max_batch=1,
                            eos_token_id=eos)
    assert out[-1] == eos and len(out) <= 3
    np.testing.assert_array_equal(out, ref[:len(out)])
    assert eng.pool.pages_in_use == 0


def test_page_recycling_cannot_leak_stale_kv():
    """B can only run on A's recycled pages, its tail page partly filled
    with A's rows: its output must equal a run on a pristine pool."""
    jm, tm = _models(62)
    r = np.random.RandomState(3)
    a_prompt, b_prompt = r.randint(0, 97, (21,)), r.randint(0, 97, (5,))
    kw = dict(page_size=8, max_batch=1, chunk_size=8,
              num_pages=1 + -(-(21 + 8) // 8))
    eng, (_, b_out) = _pair_run(jm, tm, [a_prompt, b_prompt], [8, 8], **kw)
    assert eng.stats.requests_finished == 2
    (fresh,) = _serve(ServingEngine(tm, device="cpu", **kw), [b_prompt], [8])
    np.testing.assert_array_equal(b_out, fresh)


def test_admission_waits_for_page_capacity():
    jm, tm = _models(64)
    r = np.random.RandomState(4)
    prompts = [r.randint(0, 97, (9,)), r.randint(0, 97, (7,))]
    kw = dict(page_size=8, max_batch=2, chunk_size=8,
              num_pages=1 + -(-(9 + 6) // 8))
    eng = ServingEngine(tm, device="cpu", **kw)
    for p in prompts:
        eng.submit(p, 6)
    eng.step()
    assert eng.active == 1 and eng.pending == 1, \
        "second request admitted beyond pool capacity"
    assert eng.stats.blocked_pool_pressure == 1
    _pair_run(jm, tm, prompts, [6, 6], **kw)


def test_page_pool_accounting_and_double_free():
    pool = PagePool(2, 9, 8, 4, 16, dtype=torch.float32, device="cpu")
    ref = JaxPagePool(2, 9, 8, 4, 16, dtype=jnp.float32)
    assert pool.page_bytes == ref.page_bytes
    for p in (pool, ref):
        assert p.num_free == 8
        pages = p.alloc(3)
        assert 0 not in pages, "null page must never be handed out"
        p.incref(pages[0])                       # a second holder
        with pytest.raises(ValueError):
            p.free([pages[0]])                   # free while shared
        assert p.decref(pages[0]) is False
        p.free(pages)
        with pytest.raises(ValueError):
            p.free([pages[0]])                   # double free
        with pytest.raises(ValueError):
            p.decref(pages[1])
        with pytest.raises(MemoryError):
            p.alloc(100)
    assert pool.stats() == ref.stats()


def test_submit_validation():
    _, tm = _models(66)
    eng = ServingEngine(tm, device="cpu", page_size=8, max_batch=1)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((60,), np.int32), 10)    # exceeds max_seq_len
    with pytest.raises(ValueError):
        eng.submit(np.asarray([1, 97, 2]), 4)        # id past the vocab
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):                    # bad sampling params
        with pytest.raises(ValueError):
            eng.submit(np.zeros((4,), np.int32), 4, **bad)
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", kv_cache_dtype="fp8")
    small = ServingEngine(tm, device="cpu", page_size=8, max_batch=1,
                          num_pages=3)
    with pytest.raises(ValueError):
        small.submit(np.zeros((30,), np.int32), 8)   # can never fit


def test_int8_kv_pool_matches_jax():
    jm, tm = _models(67)
    r = np.random.RandomState(5)
    prompts = [r.randint(0, 97, (n,)) for n in (5, 19, 3, 12)]
    eng, _ = _pair_run(jm, tm, prompts, [6, 4, 7, 5], page_size=8,
                       max_batch=3, chunk_size=8, kv_cache_dtype="int8")
    k_q, k_s, v_q, v_s = eng.pool.arrays
    assert k_q.dtype == torch.int8 and k_s.dtype == torch.float32
    assert k_s.shape == k_q.shape[:-1]
    ref = JaxPagePool(2, 9, 8, 4, 8, quantized=True)
    pool = PagePool(2, 9, 8, 4, 8, quantized=True, device="cpu")
    assert pool.page_bytes == ref.page_bytes
    assert PagePool.dense_bytes(2, 64, 2, 4, 8, quantized=True) == \
        JaxPagePool.dense_bytes(2, 64, 2, 4, 8, quantized=True)


def _first_diff_is_tie(tm, prompt, got, want, kw):
    """Where the port's and the JAX engine's sampled streams first differ,
    the top two perturbed logits (the request's own key at that position)
    must lie within 1e-5."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return True
    j = int(diff[0])
    seq = np.concatenate([prompt, want[:j]])
    with torch.no_grad():
        logits = tm(torch.from_numpy(seq[None]).long())[0, -1].float()
    pos = len(seq)
    key = jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), pos)
    lg = logits.numpy() / kw["temperature"]
    if kw.get("top_k"):
        lg = np.where(lg < np.sort(lg)[-kw["top_k"]], -np.inf, lg)
    if kw.get("top_p", 1.0) < 1.0:
        srt = np.sort(lg)[::-1]
        e = np.exp(srt - srt[0])
        cum = np.cumsum(e / e.sum())
        lg = np.where(lg < srt[min(np.sum(cum < kw["top_p"]), len(srt) - 1)],
                      -np.inf, lg)
    scores = np.asarray(jax.random.gumbel(key, lg.shape)) + lg
    top2 = np.sort(scores)[-2:]
    return top2[1] - top2[0] <= 1e-5


@pytest.mark.parametrize("kv_cache_dtype", ["model", "int8"])
def test_sampled_requests_match_jax(kv_cache_dtype):
    jm, tm = _models(68)
    r = np.random.RandomState(6)
    prompts = [r.randint(0, 97, (n,)) for n in (6, 13, 4, 9, 11)]
    news = [7, 5, 8, 6, 4]
    sampling = [dict(temperature=0.8, top_k=20, top_p=0.9, seed=11),
                {},                                   # greedy among them
                dict(temperature=1.2, seed=2 ** 32 + 7),
                dict(temperature=0.7, top_p=0.8, seed=5),
                dict(temperature=1.0, top_k=3)]       # seed: the rid
    kw = dict(page_size=8, max_batch=3, chunk_size=8,
              kv_cache_dtype=kv_cache_dtype)
    port = ServingEngine(tm, device="cpu", **kw)
    ref = JaxServingEngine(jm, **kw)
    got = _serve(port, prompts, news, sampling=sampling)
    want = _serve(ref, prompts, news, sampling=sampling)
    np.testing.assert_array_equal(got[1], want[1])    # the greedy request
    for i, s in enumerate(sampling):
        assert len(got[i]) == news[i]
        if s:
            eff = dict(s, seed=(s.get("seed", i)) & 0xFFFFFFFF)
            assert _first_diff_is_tie(tm, prompts[i], got[i], want[i],
                                      eff), (i, got[i], want[i])
    ps, js = port.stats.to_dict(), ref.stats.to_dict()
    assert {k: ps[k] for k in SCHEDULE_KEYS} == \
        {k: js[k] for k in SCHEDULE_KEYS}


def test_sampled_streams_depend_only_on_seed_and_position():
    """Resubmitted in reverse order to a fresh engine (other slots, other
    co-batched requests), sampled requests draw the same tokens."""
    _, tm = _models(69)
    r = np.random.RandomState(7)
    prompts = [r.randint(0, 97, (n,)) for n in (5, 12, 8, 3)]
    sampling = [dict(temperature=0.9, top_k=30, top_p=0.95, seed=100 + i)
                for i in range(4)]
    kw = dict(page_size=8, max_batch=2, chunk_size=8)
    first = _serve(ServingEngine(tm, device="cpu", **kw), prompts, [6] * 4,
                   sampling=sampling)
    again = _serve(ServingEngine(tm, device="cpu", **kw), prompts[::-1],
                   [6] * 4, sampling=sampling[::-1])[::-1]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
