"""Shared harness of the port's serving tests: one small GPT built by the
JAX package and carried into the port by the weight bridge, the two
engines driven through the same workload, and the checks that hold the
port to the JAX engine -- tokens, schedule counters, pool and pagesan
books.  The JAX engine runs as its own tests run it (its paged kernel in
interpret mode on the CPU)."""
import numpy as np
import jax
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.serving import ServingEngine as JaxServingEngine
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.serving import ServingEngine
from paddle_ray_tpu_torch.weights import gpt_from_jax_state_dict

SHAPE = dict(vocab_size=97, max_seq_len=128, hidden_size=64, num_layers=2,
             num_heads=4, dropout=0.0, use_rotary=True)
PAGE = 16
SCHEDULE_KEYS = ("prefill_tokens", "padded_prefill_tokens", "decode_tokens",
                 "prefix_hit_tokens", "draft_tokens", "accepted_tokens",
                 "mixed_steps", "requests_finished", "blocked_pool_pressure",
                 "blocked_no_slot", "preempted_total", "cancelled_total",
                 "deadline_expired_total", "step_failures", "retries_total")

_MODELS = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread, restored after: the small model's
    ops are tiny, and pytest-xdist's workers would otherwise each spread
    them over every core (the port's engine ran 14x slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(seed, **over):
    """(JAX GPT, port GPT on the CPU) with the same weights, cached per
    seed and shape."""
    key = (seed, tuple(sorted(over.items())))
    if key not in _MODELS:
        shape = dict(SHAPE, **over)
        prt.seed(seed)
        jm = jax_build_gpt(JaxGPTConfig(**shape))
        state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        _MODELS[key] = (jm, gpt_from_jax_state_dict(GPTConfig(**shape),
                                                    state, device="cpu"))
    return _MODELS[key]


def engines(jm, tm, **kw):
    """(port engine, JAX engine) with the same keywords (``sanitize`` on
    unless given)."""
    kw.setdefault("sanitize", True)
    return ServingEngine(tm, device="cpu", **kw), JaxServingEngine(jm, **kw)


def serve(engine, submits):
    """Submit ``[(prompt, max_new, submit keywords)]`` and run to drain;
    outputs in submit order."""
    rids = [engine.submit(p, n, **skw) for p, n, skw in submits]
    out = engine.run()
    return [np.asarray(out[r]) for r in rids]


def books(eng):
    """The pool's books and, with the sanitizer on, its shadow books."""
    out = {"pool": eng.pool.stats()}
    if eng.sanitizer is not None:
        out["shadow"] = eng.sanitizer.shadow_stats()
        out["pagesan"] = eng.sanitizer.snapshot()
    if eng.prefix is not None:
        out["cached_pages"] = eng.prefix.cached_pages
    return out


def assert_same(port, port_out, ref, ref_out, statuses=True):
    """Tokens equal request by request; schedule counters, terminal
    statuses and books equal."""
    assert len(port_out) == len(ref_out)
    for i, (a, b) in enumerate(zip(port_out, ref_out)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    ps, js = port.stats.to_dict(), ref.stats.to_dict()
    assert sorted(ps) == sorted(js), "stats schema drifted"
    assert {k: ps[k] for k in SCHEDULE_KEYS} == \
        {k: js[k] for k in SCHEDULE_KEYS}
    if statuses:
        assert {r: s.status for r, s in port.request_stats.items()} == \
            {r: s.status for r, s in ref.request_stats.items()}
    assert books(port) == books(ref)
    assert port.executable_count == ref.executable_count


def pair(jm, tm, submits, **kw):
    """Serve ``submits`` on both engines and hold the port to JAX."""
    port, ref = engines(jm, tm, **kw)
    got, want = serve(port, submits), serve(ref, submits)
    assert_same(port, got, ref, want)
    return port, got


def drain_stream(q):
    out = []
    while True:
        t = q.get_nowait()
        if t is None:
            break
        out.append(int(t))
    assert q.empty(), "tokens after the end-of-stream sentinel"
    return out


def first_diff_is_tie(tm, prompt, got, want, kw):
    """Where the port's and the JAX engine's sampled streams first differ,
    the top two perturbed logits (the request's own key at that position)
    must lie within 1e-5 (the frameworks' ``log`` may differ by an ulp)."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return True
    j = int(diff[0])
    seq = np.concatenate([prompt, want[:j]])
    with torch.no_grad():
        logits = tm(torch.from_numpy(seq[None]).long())[0, -1].float()
    key = jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), len(seq))
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
