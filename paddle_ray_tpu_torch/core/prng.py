"""JAX's threefry random numbers in PyTorch (the keys ``jax.random`` gives
the JAX package's sampling, bit for bit).

A key is the ``[2]`` pair of uint32 words of a JAX legacy key
(``jax.random.PRNGKey`` / ``jax.random.key_data``), held here as int64
values in ``[0, 2**32)``: PyTorch has no full uint32 arithmetic, so every
step of the hash works on int64 tensors masked back to 32 bits.  Every
function also takes a batch of keys ``[..., 2]`` and maps over it, as
``jax.vmap`` over the JAX function would.

This follows JAX 0.9 with its defaults: ``jax_threefry_partitionable``
on (random bits are ``bits1 ^ bits2`` of one hash of a 64-bit counter
split in two words, ``jax/_src/prng.py:_threefry_random_bits_partitionable``;
``split`` hashes the counters ``0..num-1`` the same way), 64-bit mode off
(``PRNGKey(seed)`` keeps the low 32 bits of the seed: ``[0, seed mod
2**32]``), and Gumbel noise of the ``"low"`` dynamic range.

The bits and the uniforms are exact.  ``gumbel`` applies ``log`` twice,
and PyTorch's and XLA's ``log`` may differ by one ulp, so a token drawn
by :func:`categorical` can differ from JAX's where two perturbed logits
lie within an ulp of each other.

The hash is about 170 elementwise tensor operations; on a CUDA tensor
each is one launch.  One key on the host hashing a few counters (a key
split, a fold-in, a ``randint`` seed) runs the same arithmetic on Python
integers instead: there a tensor operation a word would cost more than
the whole hash.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "as_key", "threefry2x32", "fold_in", "split",
           "random_bits", "uniform", "bernoulli", "randint", "gumbel",
           "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys ``[..., 2]``) as an int64 tensor of
    uint32 values: from a tensor, a numpy array (e.g.
    ``np.asarray(jax.random.key_data(k))``) or a sequence."""
    if isinstance(key, torch.Tensor):
        key = key.to(device=device, dtype=torch.int64)
    else:
        key = torch.as_tensor(np.asarray(key).astype(np.int64),
                              device=device)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] words, got {tuple(key.shape)}")
    return key & _MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # x < 2**32 and r < 32, so x << r stays inside int64
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 tensors of uint32 values; returns the two output words
    (``jax/_src/prng.py:_threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


# at most this many counters of one host key hash on Python integers
_SCALAR_COUNTERS = 16


def _host_scalar(key: torch.Tensor) -> bool:
    return key.device.type == "cpu" and key.dim() == 1


def _hash_counters(key: torch.Tensor, shape: Sequence[int]):
    """Hash the flat counters ``0..prod(shape)-1`` (a 64-bit iota split
    into high and low words) under each key: words of shape
    ``key.shape[:-1] + shape``."""
    key = as_key(key)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if _host_scalar(key) and n <= _SCALAR_COUNTERS:
        k1, k2 = key.tolist()
        words = [threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(n)]
        return tuple(torch.tensor([w[j] for w in words],
                                  dtype=torch.int64).reshape(shape)
                     for j in (0, 1))
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & _MASK).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    return threefry2x32(k1, k2, hi, lo)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data mod 2**32)``.  ``data`` is an int or an integer tensor that
    broadcasts against ``key.shape[:-1]``."""
    key = as_key(key)
    if _host_scalar(key) and isinstance(data, int):
        return torch.tensor(threefry2x32(*key.tolist(), 0, data & _MASK),
                            dtype=torch.int64)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` keys."""
    y1, y2 = _hash_counters(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 tensor of uint32
    values, shape ``key.shape[:-1] + shape``."""
    bits1, bits2 = _hash_counters(key, shape)
    return bits1 ^ bits2


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in ``[1, 2)``, minus 1, scaled
    and clipped below at ``minval``."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    f = f * float(np.float32(hi - lo)) + float(lo)
    return torch.clamp(f, min=float(lo))


def bernoulli(key, p: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` (``"low"``
    mode): ``uniform(key, shape) < p``, ``p`` rounded to float32."""
    return uniform(key, shape) < float(np.float32(p))


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 values held in int64 (``b`` a
    tensor or an int), without the int64 overflow of the full product:
    ``a`` in 16-bit halves."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK


def randint(key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for int
    bounds inside int32 (JAX refuses others in 32-bit mode): two words of
    bits (``split(key)``), combined modulo the span in uint32 arithmetic
    (``jax/_src/random.py:_randint``).  An int32 tensor of shape
    ``key.shape[:-1] + shape``."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not _I32_MIN <= v <= _I32_MAX:
            raise OverflowError(f"randint bound {v} is outside int32")
    span = (maxval - minval) if maxval > minval else 1
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    # 2**32 mod span, as JAX computes it: (2**16 mod span)**2 wrapped to
    # 32 bits, mod span
    multiplier = (((2 ** 16 % span) ** 2) & _MASK) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & _MASK
    out = minval + offset % span
    return out.to(torch.int32)


def gumbel(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (``"low"`` mode):
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for ONE key: the
    Gumbel-max draw with noise over the whole of ``logits``' shape.
    Returns int64 indices of shape ``logits.shape[:-1]``."""
    key = as_key(key, device=logits.device)
    if key.dim() != 1:
        raise ValueError("categorical takes one key; batch keys through "
                         "gumbel(keys, (V,))")
    noise = gumbel(key, logits.shape)
    return torch.argmax(noise + logits, dim=-1)

