"""Per-layer decode helpers shared by the paged serving steps (the port's
counterparts of the helpers in ``paddle_ray_tpu/models/generation.py``).

The dense ``generate()`` loop, sampling and the weight-only int8 path are
not ported yet; these are the pieces the paged mixed step runs.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .gpt import rotary_sincos

__all__ = ["_unpack_qkv", "_qkv_chunk", "_apply_rotary_positions",
           "_embed_chunk", "_head_logits", "_block_decode"]


def _head_logits(model, h: torch.Tensor) -> torch.Tensor:
    """LM head over ``h [B, S, H]`` -> ``[B, S, V]``."""
    return model.head(h, model._embed_weight())


def _unpack_qkv(attn, x: torch.Tensor):
    """Fused projection + unpack to q, k, v ``[B, S, h, d]``: the qkv
    columns are laid out ``[h, 3, d]`` (head-contiguous)."""
    cfg = attn.cfg
    b, s, _ = x.shape
    qkv = attn.qkv(x).reshape(b, s, cfg.num_heads, 3, cfg.head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


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


def _block_decode(block, x_t: torch.Tensor, cache, pos,
                  attn_fn: Callable) -> Tuple[torch.Tensor, object]:
    """One step through a block; ``attn_fn(attn, x, cache, pos) -> (out,
    new_cache)`` abstracts the cache format, so every path shares this one
    residual/MLP wiring."""
    a, cache = attn_fn(block.attn, block.ln1(x_t), cache, pos)
    h = x_t + a
    return h + block.mlp(block.ln2(h)), cache
