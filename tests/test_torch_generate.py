"""The port's ``generate()`` against the JAX package's, on the CPU.

Both sides hold the same float32 weights (a JAX model's randomised state
dict carried over by ``gpt_from_jax_state_dict``), rotary on and off.
Greedy tokens must be equal for every path: the dense cache with the
fused kernel (the JAX Pallas kernel in interpret mode, the port's plain
version of its CUDA kernel) and with the plain chain, with and without
prompt buckets, int8 weights (``quantize_for_decode``), the int8 KV cache,
the paged layout in the model's dtype and in int8, and eos padding.
Sampled tokens (``rng`` = JAX's ``PRNGKey(0)`` words) must be equal up to
the first position where they differ, and there the top two perturbed
logits must lie within 1e-5 (the two frameworks' ``log`` may differ by an
ulp, see ``core/prng.py``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.models.generation import generate as jax_generate
from paddle_ray_tpu.models.generation import (
    quantize_for_decode as jax_quantize_for_decode)
from paddle_ray_tpu_torch.models.generation import (generate,
                                                     quantize_for_decode)
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.ops.decode_attention import fused_decode_attention
from paddle_ray_tpu_torch.ops.decode_matmul import int8_stream_matmul
from paddle_ray_tpu_torch.weights import gpt_from_jax_state_dict

SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)
NEW = 8
TIE = 1e-5

_MODELS = {}


def _pair(use_rotary):
    """(JAX model, port model) with one set of random weights, cached per
    rotary setting (the models are read-only here)."""
    if use_rotary not in _MODELS:
        prt.seed(3)
        jm = jax_build_gpt(JaxGPTConfig(**SHAPE, use_rotary=use_rotary))
        r = np.random.RandomState(3)
        state = {}
        for k, a in jm.state_dict().items():
            a = np.asarray(a, np.float32)
            if k.endswith(("ln1.weight", "ln2.weight", "norm.weight")):
                state[k] = (1.0 + 0.1 * r.randn(*a.shape)).astype(np.float32)
            else:
                state[k] = (0.3 * r.randn(*a.shape)).astype(np.float32)
        jm.load_state_dict(state)
        tm = gpt_from_jax_state_dict(GPTConfig(**SHAPE,
                                               use_rotary=use_rotary),
                                     state, device="cpu")
        _MODELS[use_rotary] = (jm, tm)
    return _MODELS[use_rotary]


def _prompt(seed, b=2, t0=7):
    return np.random.RandomState(seed).randint(0, 97, (b, t0)).astype(
        np.int32)


def _both(jm, tm, ids, **kw):
    want = np.asarray(jax_generate(jm, jnp.asarray(ids), NEW, **kw))
    got = generate(tm, torch.from_numpy(ids), NEW, **kw)
    assert got.shape == (ids.shape[0], ids.shape[1] + NEW)
    return got.numpy(), want


# (name, generate keyword arguments)
GREEDY_CASES = [
    ("dense_fused", dict(fused_attention=True)),
    ("dense_unfused_bucketed", dict(fused_attention=False)),
    ("dense_unfused_unbucketed", dict(fused_attention=False,
                                      prompt_buckets=False)),
    ("dense_fused_int8_kv", dict(fused_attention=True,
                                 kv_cache_dtype="int8")),
    ("dense_unfused_int8_kv", dict(fused_attention=False,
                                   kv_cache_dtype="int8")),
    ("paged", dict(kv_layout="paged", page_size=8)),
    ("paged_int8_kv", dict(kv_layout="paged", page_size=8,
                           kv_cache_dtype="int8")),
]


@pytest.mark.parametrize("use_rotary", [False, True])
@pytest.mark.parametrize("name,kw", GREEDY_CASES,
                         ids=[c[0] for c in GREEDY_CASES])
def test_greedy_matches_jax(use_rotary, name, kw):
    jm, tm = _pair(use_rotary)
    got, want = _both(jm, tm, _prompt(len(name)), **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_rotary", [False, True])
@pytest.mark.parametrize("kw", [dict(fused_attention=True),
                                dict(fused_attention=False),
                                dict(fused_attention=True,
                                     kv_cache_dtype="int8")],
                         ids=["fused", "unfused", "fused_int8_kv"])
def test_int8_weights_match_jax(use_rotary, kw):
    jm, tm = _pair(use_rotary)
    jq, tq = jax_quantize_for_decode(jm), quantize_for_decode(tm)
    got, want = _both(jq, tq, _prompt(40), **kw)
    np.testing.assert_array_equal(got, want)


def test_eos_pads_after_the_first_eos():
    jm, tm = _pair(True)
    ids = _prompt(50)
    free, _ = _both(jm, tm, ids, fused_attention=False)
    eos = int(free[0, ids.shape[1] + 2])
    got, want = _both(jm, tm, ids, fused_attention=False, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    row = got[0, ids.shape[1]:]
    first = int(np.argmax(row == eos))
    assert first <= 2 and (row[first:] == eos).all()


def _perturbed(jm, seq, t0, j, key, temperature, top_k, top_p):
    """JAX's perturbed logits ``[B, V]`` for the token at new position
    ``j``: the model's logits after ``seq[:, :t0 + j]``, cut and tempered
    as ``_sample`` does, plus the Gumbel noise of the step's subkey."""
    logits = jm(jnp.asarray(seq[:, :t0 + j]))[:, -1].astype(jnp.float32)
    logits = logits / temperature
    if top_k:
        kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p < 1.0:
        srt = jnp.sort(logits, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(srt, axis=-1), axis=-1)
        cutoff = jnp.take_along_axis(
            srt, jnp.sum(cum < top_p, axis=-1)[:, None], axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return np.asarray(jax.random.gumbel(key, logits.shape) + logits)


@pytest.mark.parametrize("kw", [dict(fused_attention=True),
                                dict(kv_layout="paged", page_size=8,
                                     kv_cache_dtype="int8")],
                         ids=["dense_fused", "paged_int8_kv"])
def test_sampled_matches_jax_up_to_ulp_ties(kw):
    jm, tm = _pair(True)
    ids = _prompt(60)
    t0 = ids.shape[1]
    samp = dict(temperature=0.8, top_k=20, top_p=0.9)
    rng = jax.random.PRNGKey(0)
    want = np.asarray(jax_generate(jm, jnp.asarray(ids), NEW, rng=rng,
                                   **samp, **kw))
    got = generate(tm, torch.from_numpy(ids), NEW,
                   rng=np.asarray(jax.random.key_data(rng)), **samp,
                   **kw).numpy()
    np.testing.assert_array_equal(got[:, :t0], ids)
    diff = np.nonzero((got != want).any(axis=0))[0]
    if diff.size == 0:
        return
    j = int(diff[0]) - t0
    # the subkey of new token j: split once for the prefill token, then
    # once more for every step
    carry, sub = jax.random.split(rng)
    for _ in range(j):
        carry, sub = jax.random.split(carry)
    scores = _perturbed(jm, want, t0, j, sub, **samp)
    for row in np.nonzero(got[:, t0 + j] != want[:, t0 + j])[0]:
        top2 = np.sort(scores[row])[-2:]
        assert top2[1] - top2[0] <= TIE, (row, j, top2)


def test_sampling_is_reproducible_and_keyed():
    _, tm = _pair(False)
    ids = torch.from_numpy(_prompt(70))
    kw = dict(temperature=1.0, fused_attention=False)
    a = generate(tm, ids, NEW, rng=np.asarray([0, 1], np.uint32), **kw)
    b = generate(tm, ids, NEW, rng=np.asarray([0, 1], np.uint32), **kw)
    c = generate(tm, ids, NEW, rng=np.asarray([0, 2], np.uint32), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_gpt_generate_and_cpu_counts_nothing():
    _, tm = _pair(True)
    ids = torch.from_numpy(_prompt(80))
    before = (fused_decode_attention.launches,
              fused_decode_attention.launches_q8,
              int8_stream_matmul.launches)
    via_method = tm.generate(ids, NEW, fused_attention=True)
    torch.testing.assert_close(via_method,
                               generate(tm, ids, NEW, fused_attention=True),
                               rtol=0, atol=0)
    generate(quantize_for_decode(tm), ids, NEW, kv_cache_dtype="int8")
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (fused_decode_attention.launches,
            fused_decode_attention.launches_q8,
            int8_stream_matmul.launches) == before


def test_validation():
    _, tm = _pair(False)
    ids = torch.from_numpy(_prompt(90))
    with pytest.raises(ValueError):
        generate(tm, ids, NEW, kv_cache_dtype="fp8")
    with pytest.raises(ValueError):
        generate(tm, ids, NEW, kv_layout="ring")
    with pytest.raises(ValueError):
        generate(tm, ids, 60)                    # past max_seq_len
    with pytest.raises(ValueError):
        generate(tm, ids, NEW, temperature=0.5)  # sampling needs rng
    torch.testing.assert_close(generate(tm, ids, 0), ids.long())
