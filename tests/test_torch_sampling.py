"""The port's threefry keys and sampling against ``jax.random`` and the
JAX package's sampling functions.

Keys, ``fold_in``, ``split``, random bits and uniforms must be bit-exact
(seeds 0, 2**31 + 5 and 2**32 - 1; positions 0..4095).  Gumbel noise
applies ``log`` twice, and PyTorch's and XLA's ``log`` differ by one ulp
at times, so it is held to 2 ulp of ``max(|g|, 1)``.  Sampled tokens on
fixed logits must be equal, except where the top two perturbed logits lie
within 1e-5 of each other (an ulp-level tie)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_ray_tpu.models.generation import _sample as jax_sample
from paddle_ray_tpu.models.generation import (
    fold_sample_keys as jax_fold_sample_keys,
    sample_tokens as jax_sample_tokens)
from paddle_ray_tpu_torch.core import prng
from paddle_ray_tpu_torch.models.generation import (_sample,
                                                     fold_sample_keys,
                                                     sample_tokens)

SEEDS = [0, 2 ** 31 + 5, 2 ** 32 - 1]
POSITIONS = np.arange(4096)
TIE = 1e-5


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 40 + 3])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(_jkey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_are_bit_exact(seed):
    jk = _jkey(seed)
    want = np.asarray(jax.vmap(lambda p: jax.random.fold_in(jk, p))(
        jnp.asarray(POSITIONS)))
    got = prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(POSITIONS))
    np.testing.assert_array_equal(got.numpy(), want)
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed),
                                                 num).numpy(),
                                      np.asarray(jax.random.split(jk, num)))
    # a key given as JAX's words, and a batch of keys
    keys = np.asarray(jax.random.split(jk, 3))
    np.testing.assert_array_equal(
        prng.split(keys).numpy(),
        np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys))))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_are_bit_exact(seed):
    jk = jax.random.fold_in(_jkey(seed), 77)
    tk = prng.as_key(np.asarray(jk))
    for shape in ((4096,), (3, 97)):
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            prng.uniform(tk, shape).numpy().view(np.int32),
            np.asarray(jax.random.uniform(jk, shape)).view(np.int32))
    lo, hi = np.finfo(np.float32).tiny, 1.0
    np.testing.assert_array_equal(
        prng.uniform(tk, (4096,), lo, hi).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, (4096,), minval=lo,
                                      maxval=hi)).view(np.int32))


def test_fold_sample_keys_are_bit_exact():
    r = np.random.RandomState(0)
    seeds = np.asarray(SEEDS + list(r.randint(0, 2 ** 32, 4093,
                                              dtype=np.int64)), np.int64)
    want = np.asarray(jax_fold_sample_keys(jnp.asarray(seeds, jnp.uint32),
                                           jnp.asarray(POSITIONS,
                                                       jnp.int32)))
    got = fold_sample_keys(torch.from_numpy(seeds),
                           torch.from_numpy(POSITIONS))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp(seed):
    jk = _jkey(seed)
    want = np.asarray(jax.random.gumbel(jk, (100_000,)))
    got = prng.gumbel(prng.PRNGKey(seed), (100_000,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    # a batch of keys maps over the keys
    keys = np.asarray(jax.random.split(jk, 4))
    batch = prng.gumbel(prng.as_key(keys), (50,)).numpy()
    want_b = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (50,)))(
        jnp.asarray(keys)))
    assert np.all(np.abs(batch - want_b)
                  <= 2 * np.spacing(np.maximum(np.abs(want_b), 1.0)))


def _near_tie(scores, got, want):
    """True where the port's and JAX's draws differ only because the top
    two perturbed logits of the row lie within TIE of each other."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= TIE
    return np.all((got == want) | close)


def _logits(seed, s, v):
    r = np.random.RandomState(seed)
    return (3.0 * r.randn(s, v)).astype(np.float32)


# (temperature, top_k, top_p) of each row: greedy, temperature only,
# top-k, top-p, both cuts
ROWS = [(0.0, 0, 1.0), (0.8, 0, 1.0), (1.3, 5, 1.0), (0.7, 0, 0.9),
        (1.0, 40, 0.95), (0.0, 7, 0.5), (2.0, 1, 1.0), (0.5, 0, 0.3)]


def test_sample_tokens_matches_jax():
    v = 211
    for trial in range(6):
        logits = _logits(trial, len(ROWS), v)
        temps, ks, ps = (np.asarray(c, dt) for c, dt in zip(
            zip(*ROWS), (np.float32, np.int32, np.float32)))
        seeds = np.arange(len(ROWS), dtype=np.int64) * 1000 + trial
        pos = np.full(len(ROWS), 17 + trial, np.int32)
        jkeys = jax_fold_sample_keys(jnp.asarray(seeds, jnp.uint32),
                                     jnp.asarray(pos))
        want = np.asarray(jax_sample_tokens(
            jnp.asarray(logits), jkeys, jnp.asarray(temps), jnp.asarray(ks),
            jnp.asarray(ps)))
        tkeys = fold_sample_keys(torch.from_numpy(seeds),
                                 torch.from_numpy(pos))
        got = sample_tokens(torch.from_numpy(logits), tkeys,
                            torch.from_numpy(temps), torch.from_numpy(ks),
                            torch.from_numpy(ps))
        assert got.dtype == torch.int32
        got = got.numpy()
        np.testing.assert_array_equal(got[temps <= 0],
                                      logits[temps <= 0].argmax(-1))
        # the perturbed scores the draws maximise (JAX's noise)
        noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(
            jkeys))
        assert _near_tie(noise + logits / temps.clip(1e-6)[:, None], got,
                         want), (got, want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.9, 0, 1.0), (1.1, 8, 1.0), (0.8, 0, 0.85),
    (1.0, 20, 0.9)])
def test_sample_matches_jax(temperature, top_k, top_p):
    v = 157
    for trial in range(4):
        logits = _logits(100 + trial, 5, v)
        jk = jax.random.fold_in(_jkey(trial), 3)
        want = np.asarray(jax_sample(jnp.asarray(logits), jk, temperature,
                                     top_k, top_p))
        got = _sample(torch.from_numpy(logits), prng.as_key(np.asarray(jk)),
                      temperature, top_k, top_p).numpy()
        if temperature == 0.0:
            np.testing.assert_array_equal(got, want)
            continue
        noise = np.asarray(jax.random.gumbel(jk, logits.shape))
        assert _near_tie(noise + logits / np.float32(temperature), got,
                         want), (got, want)
    # no key: greedy whatever the temperature
    np.testing.assert_array_equal(
        _sample(torch.from_numpy(logits), None, 0.7, 0, 1.0).numpy(),
        logits.argmax(-1))


def test_categorical_matches_jax():
    logits = _logits(7, 6, 333)
    jk = _jkey(2 ** 31 + 5)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(2 ** 31 + 5),
                           torch.from_numpy(logits)).numpy()
    noise = np.asarray(jax.random.gumbel(jk, logits.shape))
    assert _near_tie(noise + logits, got, want)
    with pytest.raises(ValueError):
        prng.categorical(prng.split(prng.PRNGKey(0)),
                         torch.from_numpy(logits))
    with pytest.raises(ValueError):
        prng.as_key([1, 2, 3])
