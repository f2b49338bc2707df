"""Autoregressive generation with a KV cache (the port of
``paddle_ray_tpu/models/generation.py``).

:func:`generate` prefills the prompt's K/V for every layer, then decodes
one token at a time against a head-major ``[B, h, T, d]`` cache -- dense,
in the model's dtype or int8 per (token, head) -- or against the paged pool
of the serving engine (``kv_layout="paged"``).  Where the JAX package runs
one jitted program (a ``lax.scan`` over the steps), this is a Python loop
over eager steps; the cache rows are written in place.

Decode attention on the dense cache goes through the fused kernel of
:mod:`..ops.decode_attention` (``fused_attention=None``: on for a CUDA
model, the plain chain on the CPU, as the JAX default is on for the TPU
only); ``fused_attention=False`` runs the plain chain
(:func:`_attn_decode`, :func:`_attn_decode_q8`).  There is no probe and no
quiet fallback: on CUDA the kernel launches or raises.

:func:`quantize_for_decode` makes a weight-only int8 copy of a GPT; its
linears and tied LM head stream int8 weights through
:mod:`..ops.decode_matmul` at decode row counts.

Sampling: greedy / temperature / top-k / top-p with JAX's threefry keys
(:mod:`..core.prng`), so a sampled stream draws the JAX package's random
bits; a token can still differ where two perturbed logits lie within an
ulp (the two frameworks' ``log`` differ by one ulp at times).
"""
from __future__ import annotations

import copy
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.dtypes import canonicalize_dtype
from ..nn import functional as F
from ..ops.decode_attention import DECODE_BLOCK_T, fused_decode_attention
from ..ops.decode_matmul import MAX_KERNEL_ROWS, int8_stream_matmul
from ..parallel.tp import (ColumnParallelLinear, RowParallelLinear,
                           VocabParallelEmbedding)
from ..quantization.quant import (WeightOnlyInt8Embedding,
                                  WeightOnlyInt8Linear, replace_layers)
from .gpt import apply_rotary, rotary_sincos

__all__ = ["generate", "quantize_for_decode", "sample_tokens",
           "fold_sample_keys"]

_NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# weight-only int8 decode
# ---------------------------------------------------------------------------
def quantize_for_decode(model):
    """A decode copy of a GPT with every block linear (qkv/out/fc1/fc2 and
    an untied head projection) replaced by :class:`WeightOnlyInt8Linear`
    and the embedding by :class:`WeightOnlyInt8Embedding`.  Activations
    and the KV cache stay exact; pass ``kv_cache_dtype="int8"`` to
    :func:`generate` for the cache.  The caller's model is left as it is.

    The fused qkv weight, scale and bias are re-laid-out from the training
    columns ``[h, 3, d]`` to ``[3, h, d]``, so the decode unpack is three
    contiguous slices (``attn.qkv_contiguous``)."""
    model = copy.deepcopy(model)
    _quantize_in_place(model)
    return model


def _quantize_in_place(model) -> None:
    cfg = model.cfg
    with torch.no_grad():
        replace_layers(
            model,
            lambda m: isinstance(m, (ColumnParallelLinear,
                                     RowParallelLinear)),
            lambda m: WeightOnlyInt8Linear.from_weight(m.weight, m.bias))
        replace_layers(
            model, lambda m: isinstance(m, VocabParallelEmbedding),
            lambda m: WeightOnlyInt8Embedding.from_weight(m.weight))
        h, d = cfg.num_heads, cfg.head_dim
        for blk in model.blocks:
            lin = blk.attn.qkv
            lin.weight_q = (lin.weight_q.reshape(-1, h, 3, d)
                            .permute(0, 2, 1, 3).reshape(-1, 3 * h * d)
                            .contiguous())
            lin.scale = (lin.scale.reshape(h, 3, d).permute(1, 0, 2)
                         .reshape(-1).contiguous())
            if lin.bias is not None:
                lin.bias = (lin.bias.reshape(h, 3, d).permute(1, 0, 2)
                            .reshape(-1).contiguous())
            blk.attn.qkv_contiguous = True


def _head_logits(model, h: torch.Tensor) -> torch.Tensor:
    """LM head over ``h [B, S, H]`` -> ``[B, S, V]``, also for the int8
    tied embedding: up to 128 rows through the weight-streaming kernel on
    ``weight_qT``, more through one plain matmul."""
    emb = model.embedding.word_embeddings
    if model.head.proj is None and isinstance(emb, WeightOnlyInt8Embedding):
        hn = model.head.norm(h)
        b, s, hd = hn.shape
        if b * s <= MAX_KERNEL_ROWS and emb.weight_qT is not None:
            logits = int8_stream_matmul(hn.reshape(b * s, hd),
                                        emb.weight_qT, emb.scale)
            return logits.reshape(b, s, -1)
        logits = torch.matmul(hn, emb.weight_q.to(hn.dtype).T)
        return logits * emb.scale.to(hn.dtype)
    return model.head(h, model._embed_weight())


# ---------------------------------------------------------------------------
# int8 KV cache: per-(token, head) scales
# ---------------------------------------------------------------------------
def _kv_quant(x: torch.Tensor):
    """x ``[..., d]`` -> (int8 values, float32 scales ``[..., 1]``),
    clipped to [-127, 127].  The divide by 127 is a true division on every
    device, as in JAX (PyTorch's CUDA divide by a Python number multiplies
    by its reciprocal)."""
    xf = x.float()
    s = xf.abs().amax(-1, keepdim=True)
    s = torch.clamp(s / torch.full((), 127.0, device=s.device), min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def _cache_append(cache: Tuple, kh: torch.Tensor, vh: torch.Tensor,
                  pos: int) -> Tuple:
    """Write the new token's head-major ``[B, h, 1, d]`` K/V rows into the
    cache at row ``pos``, in place (the JAX package returns updated
    copies): a 2-tuple in the model's dtype, or the int8 4-tuple quantized
    per (token, head)."""
    if len(cache) == 4:
        k_q, k_s, v_q, v_s = cache
        for dst_q, dst_s, x in ((k_q, k_s, kh), (v_q, v_s, vh)):
            xq, xs = _kv_quant(x)
            dst_q[:, :, pos:pos + 1] = xq
            dst_s[:, :, pos:pos + 1] = xs
        return cache
    k_c, v_c = cache
    k_c[:, :, pos:pos + 1] = kh.to(k_c.dtype)
    v_c[:, :, pos:pos + 1] = vh.to(v_c.dtype)
    return cache


# ---------------------------------------------------------------------------
# per-layer attention prefill / decode
# ---------------------------------------------------------------------------
def _unpack_qkv(attn, x: torch.Tensor):
    """Fused projection + unpack to q, k, v ``[B, S, h, d]``: the qkv
    columns are ``[h, 3, d]`` (training layout) or, after
    :func:`quantize_for_decode`, ``[3, h, d]`` (three contiguous slices)."""
    cfg = attn.cfg
    b, s, _ = x.shape
    y = attn.qkv(x)
    h, d = cfg.num_heads, cfg.head_dim
    if getattr(attn, "qkv_contiguous", False):
        hd = h * d
        return (y[..., :hd].reshape(b, s, h, d),
                y[..., hd:2 * hd].reshape(b, s, h, d),
                y[..., 2 * hd:].reshape(b, s, h, d))
    qkv = y.reshape(b, s, h, 3, d)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _qkv(attn, x: torch.Tensor, positions):
    """x ``[B, S, Hdim]``; positions: the ``S`` absolute positions shared
    by the batch (a slice or an index tensor), for rotary."""
    cfg = attn.cfg
    q, k, v = _unpack_qkv(attn, x)
    if cfg.use_rotary:
        sin, cos = rotary_sincos(cfg.max_seq_len, cfg.head_dim,
                                 cfg.rope_theta, device=x.device)
        sin, cos = sin[positions], cos[positions]
        q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
    return q, k, v


def _attn_prefill(attn, x: torch.Tensor):
    """Full causal attention over the prompt; returns (out, k, v)."""
    b, s, hdim = x.shape
    q, k, v = _qkv(attn, x, slice(0, s))
    o = F.scaled_dot_product_attention(q, k, v, causal=True)
    return attn.out(o.reshape(b, s, hdim)), k, v


def _apply_rotary_positions(x: torch.Tensor, sin_b: torch.Tensor,
                            cos_b: torch.Tensor) -> torch.Tensor:
    """Per-(sequence, token) rotary: x ``[B, C, h, d]``; sin/cos
    ``[B, C, d/2]`` gathered at each token's own absolute position."""
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin_b[:, :, None, :].to(x.dtype)
    cos = cos_b[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _qkv_chunk(attn, x: torch.Tensor, positions: torch.Tensor):
    """Chunked qkv with per-token absolute positions ``[B, C]``.
    x ``[B, C, Hdim]`` -> q, k, v ``[B, C, h, d]``."""
    cfg = attn.cfg
    q, k, v = _unpack_qkv(attn, x)
    if cfg.use_rotary:
        sin, cos = rotary_sincos(cfg.max_seq_len, cfg.head_dim,
                                 cfg.rope_theta, device=x.device)
        sin_b, cos_b = sin[positions], cos[positions]       # [B, C, d/2]
        q = _apply_rotary_positions(q, sin_b, cos_b)
        k = _apply_rotary_positions(k, sin_b, cos_b)
    return q, k, v


def _embed_chunk(model, toks: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """toks ``[B, C]``; positions ``[B, C]`` per-token absolute positions."""
    emb = model.embedding
    h = emb.word_embeddings(toks)
    if emb.position_embeddings is not None:
        h = h + emb.position_embeddings[positions].to(h.dtype)
    return h


def _attn_decode(attn, x_t: torch.Tensor, cache: Tuple, pos: int,
                 valid: Optional[torch.Tensor] = None,
                 pos_true: Optional[int] = None):
    """One-token attention against the cache, the plain chain.

    x_t ``[B, 1, Hdim]``; cache ``(k, v)`` each ``[B, h, T, d]``; pos: the
    CACHE ROW of this token.  With prompt bucketing the row and the true
    position differ: ``pos_true`` (default ``pos``) drives rotary, and
    ``valid`` ``[T]`` (default ``arange <= pos``) masks the pad rows
    between the true prompt end and the bucket boundary.
    Returns ``(out [B, 1, Hdim], cache)``."""
    b = x_t.shape[0]
    p = pos if pos_true is None else pos_true
    q, k_t, v_t = _qkv(attn, x_t, slice(p, p + 1))
    qh = q.transpose(1, 2)                                  # [B, h, 1, d]
    k_cache, v_cache = _cache_append(cache, k_t.transpose(1, 2),
                                     v_t.transpose(1, 2), pos)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhqd,bhtd->bhqt", qh.float(),
                          k_cache.float()) * scale
    if valid is None:
        valid = torch.arange(k_cache.shape[2], device=x_t.device) <= pos
    logits = logits.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x_t.dtype)
    o = torch.einsum("bhqt,bhtd->bhqd", probs, v_cache).transpose(1, 2)
    return attn.out(o.reshape(b, 1, -1)), (k_cache, v_cache)


def _attn_decode_q8(attn, x_t: torch.Tensor, cache: Tuple, pos: int,
                    valid: Optional[torch.Tensor] = None,
                    pos_true: Optional[int] = None):
    """One-token attention against an int8 cache ``(k_q [B, h, T, d] i8,
    k_s [B, h, T, 1] f32, v_q, v_s)``, the plain chain: the K scales fold
    into the logits, the V scales into the probabilities.  ``valid`` /
    ``pos_true``: see :func:`_attn_decode`."""
    b = x_t.shape[0]
    p = pos if pos_true is None else pos_true
    q, k_t, v_t = _qkv(attn, x_t, slice(p, p + 1))
    qh = q.transpose(1, 2)
    k_q, k_s, v_q, v_s = _cache_append(cache, k_t.transpose(1, 2),
                                       v_t.transpose(1, 2), pos)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhqd,bhtd->bhqt", qh.float(), k_q.float())
    logits = logits * k_s.transpose(2, 3) * scale           # [B, h, 1, T]
    if valid is None:
        valid = torch.arange(k_q.shape[2], device=x_t.device) <= pos
    logits = logits.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * v_s.transpose(2, 3)                     # fold v scales
    o = torch.einsum("bhqt,bhtd->bhqd", probs.to(x_t.dtype),
                     v_q.to(x_t.dtype)).transpose(1, 2)
    return attn.out(o.reshape(b, 1, -1)), (k_q, k_s, v_q, v_s)


def _attn_decode_fused(attn, x_t: torch.Tensor, cache: Tuple, pos: int):
    """One-token attention through :func:`..ops.decode_attention.
    fused_decode_attention` (one kernel launch per layer).  The one-row
    cache appends (and int8 quant) stay here; the kernel reads the cache.
    The cache kind (2-tuple / int8 4-tuple) picks the kernel body."""
    b = x_t.shape[0]
    q, k_t, v_t = _qkv(attn, x_t, slice(pos, pos + 1))      # [B, 1, h, d]
    cache = _cache_append(cache, k_t.transpose(1, 2), v_t.transpose(1, 2),
                          pos)
    o = fused_decode_attention(q.transpose(1, 2), cache, pos,
                               scale=1.0 / (q.shape[-1] ** 0.5))
    return attn.out(o.transpose(1, 2).reshape(b, 1, -1)), cache


def _block_prefill(block, x: torch.Tensor):
    a, k, v = _attn_prefill(block.attn, block.ln1(x))
    h = x + a
    return h + block.mlp(block.ln2(h)), k, v


def _block_decode(block, x_t: torch.Tensor, cache, pos,
                  attn_fn: Callable) -> Tuple[torch.Tensor, object]:
    """One step through a block; ``attn_fn(attn, x, cache, pos) -> (out,
    new_cache)`` abstracts the cache format, so every path shares this one
    residual/MLP wiring."""
    a, cache = attn_fn(block.attn, block.ln1(x_t), cache, pos)
    h = x_t + a
    return h + block.mlp(block.ln2(h)), cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def fold_sample_keys(seeds: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Per-row sampling keys ``fold_in(PRNGKey(seed), position)``:
    seeds ``[S]`` (taken mod 2**32), positions ``[S]`` (the position the
    sampled token will occupy) -> ``[S, 2]`` keys.  A request's stream
    depends only on its seed and how many tokens it has, not on its batch
    slot or the dispatch order."""
    seeds = seeds.to(torch.int64) & 0xFFFFFFFF
    keys = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    return prng.fold_in(keys, positions)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling ``logits [S, V] -> tokens [S]`` int32, with per-row
    ``temperature`` / ``top_k`` / ``top_p`` (``[S]`` tensors) and keys
    ``[S, 2]``.  Rows with ``temperature <= 0`` take the argmax; ``top_k
    <= 0`` disables the top-k cut, ``top_p >= 1`` the nucleus cut.  The
    cuts mirror :func:`_sample`: the k-th largest as threshold, then the
    smallest nucleus with cumulative probability >= top_p over the
    post-top-k distribution."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    v = logits.shape[-1]
    neg = torch.tensor(_NEG_INF, device=logits.device)
    lg = logits.float() / torch.clamp(temperature.float(), min=1e-6)[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    lg = torch.where((top_k[:, None] > 0) & (lg < kth), neg, lg)
    desc = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    cut_idx = (cum < top_p.float()[:, None]).sum(-1)
    cutoff = torch.gather(desc, -1, cut_idx.clamp(0, v - 1)[:, None])
    lg = torch.where((top_p < 1.0)[:, None] & (lg < cutoff), neg, lg)
    sampled = torch.argmax(prng.gumbel(keys, (v,)) + lg, dim=-1)
    return torch.where(temperature > 0, sampled.to(torch.int32), greedy)


def _sample(logits: torch.Tensor, rng: Optional[torch.Tensor],
            temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """logits ``[B, V]`` -> tokens ``[B]`` int32, one key for the batch."""
    if temperature == 0.0 or rng is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p (keep the first token
        # crossing the threshold)
        cutoff_idx = (cum < top_p).sum(-1).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, _NEG_INF)
    return prng.categorical(rng, logits).to(torch.int32)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------
def _embed_at(model, tokens: torch.Tensor, positions) -> torch.Tensor:
    """tokens ``[B, S]``; positions: the ``S`` absolute positions shared by
    the batch (a slice or an index tensor)."""
    emb = model.embedding
    h = emb.word_embeddings(tokens)
    if emb.position_embeddings is not None:
        h = h + emb.position_embeddings[positions][None].to(h.dtype)
    return h


def _pad_rows(x: torch.Tensor, t_alloc: int) -> torch.Tensor:
    """Zero-pad the T axis (dim 2) of a ``[B, h, S, *]`` cache to
    ``t_alloc`` rows."""
    out = x.new_zeros((*x.shape[:2], t_alloc, *x.shape[3:]))
    out[:, :, :x.shape[2]] = x
    return out


def _split_rng(rng: Optional[torch.Tensor]):
    """``(carry, subkey)`` = ``split(rng)``, or ``(None, None)``."""
    if rng is None:
        return None, None
    keys = prng.split(rng)
    return keys[0], keys[1]


def generate(model, ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None,
             kv_cache_dtype: str = "model",
             fused_attention: Optional[bool] = None,
             kv_layout: str = "dense",
             prompt_buckets: Optional[bool] = None,
             page_size: Optional[int] = None,
             rng=None) -> torch.Tensor:
    """Decode ``max_new_tokens`` tokens after the prompt ``ids`` ``[B, T0]``.

    Returns ``[B, T0 + max_new_tokens]`` int64 on the model's device;
    positions after an emitted ``eos_token_id`` are padded with eos.
    ``temperature=0`` (or no ``rng``) is greedy decoding; ``rng`` is a
    threefry key (``core.prng.PRNGKey(seed)``, or the words of a JAX key).

    ``kv_cache_dtype``: ``"model"`` keeps the model dtype; ``"int8"``
    stores the cache quantized per (token, head).

    ``fused_attention``: per-layer decode attention through the fused
    kernel (None: on for a CUDA model, the plain chain on the CPU).

    ``kv_layout``: ``"dense"`` keeps the ``[B, h, T, d]`` cache;
    ``"paged"`` stores KV in pages behind a page table and runs the ragged
    paged-attention kernel, as the serving engine does.  ``page_size``
    applies to the paged layout only.

    ``prompt_buckets`` (dense, unfused; default on there): pad the prompt
    up to the next ``DECODE_BLOCK_T`` multiple and mask the pad rows out of
    every attention, with true positions -- the JAX package's bucketing,
    which gives the same tokens."""
    cfg = model.cfg
    device = model.device
    ids = torch.as_tensor(ids).to(device=device, dtype=torch.long)
    b, t0 = ids.shape
    if kv_cache_dtype not in ("model", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    if max_new_tokens <= 0:
        return ids
    t_max = t0 + max_new_tokens
    if t_max > cfg.max_seq_len:
        raise ValueError(f"{t_max} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    if rng is None and temperature > 0.0:
        raise ValueError("sampling (temperature > 0) needs rng")
    if rng is not None:
        rng = prng.as_key(rng, device=device)
    q8 = kv_cache_dtype == "int8"
    sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_token_id=eos_token_id)
    with torch.no_grad():
        if kv_layout == "paged":
            new = _generate_paged(model, ids, max_new_tokens, q8=q8,
                                  page_size=page_size, rng=rng, **sampling)
            return torch.cat([ids, new], dim=1)
        fused = (device.type == "cuda" if fused_attention is None
                 else fused_attention)
        bucketed = (not fused) if prompt_buckets is None else prompt_buckets
        if bucketed and not fused:
            t0_pad = max(t0, min(-(-t0 // DECODE_BLOCK_T) * DECODE_BLOCK_T,
                                 cfg.max_seq_len - max_new_tokens))
            ids_pad = torch.nn.functional.pad(ids, (0, t0_pad - t0))
            new = _dense_decode(model, ids_pad, t0, rng,
                                max_new_tokens=max_new_tokens, q8=q8,
                                fused=False, **sampling)
        else:
            new = _dense_decode(model, ids, t0, rng,
                                max_new_tokens=max_new_tokens, q8=q8,
                                fused=fused, **sampling)
    return torch.cat([ids, new], dim=1)


def _dense_decode(model, ids: torch.Tensor, t0: int, rng, *,
                  max_new_tokens: int, temperature: float, top_k: int,
                  top_p: float, eos_token_id: Optional[int], q8: bool,
                  fused: bool) -> torch.Tensor:
    """Prefill + step loop over the dense ``[B, h, T, d]`` cache.

    ``ids`` ``[B, t0_pad]`` is the (possibly bucket-padded) prompt; ``t0``
    the true prompt length.  Returns the new tokens ``[B, max_new]``."""
    b, t0_pad = ids.shape
    t_max = t0_pad + max_new_tokens
    # the JAX package aligns the fused path's allocation to its kernel's
    # T block; the rows past pos are never read
    t_alloc = (-(-t_max // DECODE_BLOCK_T) * DECODE_BLOCK_T if fused
               else t_max)

    # -- prefill ---------------------------------------------------------
    h = _embed_at(model, ids, slice(0, t0_pad))
    caches = []
    for blk in model.blocks:
        h, k, v = _block_prefill(blk, h)
        k, v = k.transpose(1, 2), v.transpose(1, 2)         # [B, h, S, d]
        if q8:
            (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
            cache = (kq, ks, vq, vs)
        else:
            cache = (k, v)
        caches.append(tuple(_pad_rows(c, t_alloc) for c in cache))
    logits0 = _head_logits(model, h[:, t0 - 1:t0])[:, 0]    # [B, V]

    # one subkey for the prefill sample, the other carried
    key, sub = _split_rng(rng)
    tok = _sample(logits0, sub, temperature, top_k, top_p)
    done = None if eos_token_id is None else tok == eos_token_id
    out = [tok]

    # -- decode ----------------------------------------------------------
    t_arange = torch.arange(t_alloc, device=ids.device)
    for i in range(1, max_new_tokens):
        # the carried token's CACHE ROW continues after the padded prompt,
        # its TRUE position after the real one
        pos_row = t0_pad + i - 1
        pos_true = t0 + i - 1
        x = _embed_at(model, tok[:, None].long(),
                      slice(pos_true, pos_true + 1))
        if fused:
            attn_fn = _attn_decode_fused
        else:
            # real prompt rows, plus the decode rows written so far
            valid = ((t_arange < t0)
                     | ((t_arange >= t0_pad) & (t_arange <= pos_row)))
            attn_fn = partial(_attn_decode_q8 if q8 else _attn_decode,
                              valid=valid, pos_true=pos_true)
        for li, blk in enumerate(model.blocks):
            x, caches[li] = _block_decode(blk, x, caches[li], pos_row,
                                          attn_fn)
        logits = _head_logits(model, x)[:, 0]
        if key is not None:
            key, sub = _split_rng(key)
        nxt = _sample(logits, sub, temperature, top_k, top_p)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).long()


def _generate_paged(model, ids: torch.Tensor, max_new_tokens: int, *,
                    temperature: float, top_k: int, top_p: float,
                    eos_token_id: Optional[int], q8: bool,
                    page_size: Optional[int], rng) -> torch.Tensor:
    """generate() over the paged KV layout: KV in pool pages behind a page
    table, every decode step one ragged paged-attention launch per layer
    -- the static-batch twin of the serving engine's step.  Returns the
    new tokens ``[B, max_new]``."""
    from ..ops.paged_attention import DEFAULT_PAGE_SIZE
    from ..serving.engine import paged_decode_step, paged_prefill
    from ..serving.page_pool import PagePool
    cfg = model.cfg
    b, t0 = ids.shape
    page = page_size or DEFAULT_PAGE_SIZE
    pages_per_seq = -(-(t0 + max_new_tokens) // page)
    pool = PagePool(cfg.num_layers, 1 + b * pages_per_seq, page,
                    cfg.num_heads, cfg.head_dim,
                    dtype=canonicalize_dtype(cfg.dtype), quantized=q8,
                    device=ids.device)
    # the table comes from what alloc() hands out, never an assumed order
    table = torch.from_numpy(np.asarray(
        [pool.alloc(pages_per_seq) for _ in range(b)], np.int32)).to(
            ids.device)
    pools, logits0 = paged_prefill(model, ids, t0, table, pool.arrays)
    key, sub = _split_rng(rng)
    tok = _sample(logits0, sub, temperature, top_k, top_p)
    done = None if eos_token_id is None else tok == eos_token_id
    out = [tok]
    for i in range(1, max_new_tokens):
        positions = torch.full((b,), t0 + i - 1, dtype=torch.int32,
                               device=ids.device)
        pools, logits = paged_decode_step(model, tok, positions,
                                          positions + 1, table, pools)
        if key is not None:
            key, sub = _split_rng(key)
        nxt = _sample(logits, sub, temperature, top_k, top_p)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).long()
