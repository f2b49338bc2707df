"""GPT decoder-only transformer (the port's counterpart of
``paddle_ray_tpu/models/gpt.py``).

Same configuration table, same module tree and parameter names (so a JAX
state dict maps over key for key, see :mod:`..weights`), same arithmetic:
pre-LN blocks, fused QKV laid out ``[heads, (q|k|v), dim]``, tanh GELU,
float32 LayerNorm, tied LM head, and the causal-LM loss.  Attention is
dense or flash (the CUDA kernels of :mod:`..ops.flash_attention`); remat
wraps each block in ``torch.utils.checkpoint``.  Dropout, the MoE FFN,
chunked cross-entropy, the ``"dots"`` remat policies and the multi-device
attention schemes raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..core import dtypes as _dt
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import LayerNorm
from ..ops.flash_attention import flash_attention
from ..parallel.tp import (ColumnParallelLinear, ParallelCrossEntropy,
                           RowParallelLinear, VocabParallelEmbedding,
                           normal_parameter)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPT", "GPTEmbedding",
           "GPTAttention", "GPTMLP", "GPTBlock", "GPTHead", "build_gpt",
           "gpt_loss_fn", "rotary_sincos", "apply_rotary",
           "sequence_parallel_attention"]

# attention schemes of the JAX package that need several devices
_MULTI_DEVICE_ATTN = ("ring", "ring_flash", "ulysses")


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304           # GPT-2 BPE padded to a multiple of 128
    max_seq_len: int = 2048
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None  # default 4 * hidden
    dropout: float = 0.0
    activation: str = "gelu"
    use_rotary: bool = False          # False -> learned position embeddings
    rope_theta: float = 10000.0
    attn_impl: str = "dense"          # dense | flash (ring | ring_flash | ulysses: not ported)
    tie_embeddings: bool = True
    remat: bool = True                # torch.utils.checkpoint each block
    remat_policy: str = "none"        # "none"; "dots" | "dots_attn": not ported
    # accepted for config parity; the blocks always run as a plain loop
    # (the JAX package's lax.scan does the same arithmetic)
    scan_layers: bool = True
    init_std: float = 0.02
    ln_epsilon: float = 1e-5
    dtype: Any = None                 # parameter dtype (default float32)
    # MoE FFN: not ported yet (0 experts -> dense FFN)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_gate: str = "gshard"
    moe_aux_weight: float = 1e-2
    ce_chunk: int = 0                 # chunked cross-entropy: not ported yet

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def d_ffn(self) -> int:
        return self.ffn_hidden or 4 * self.hidden_size

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0


# GPT-3 family (Brown et al. 2020 table 2.1), the JAX package's table.
GPT_CONFIGS = {
    "gpt3-125m": dict(num_layers=12, hidden_size=768, num_heads=12),
    "gpt3-350m": dict(num_layers=24, hidden_size=1024, num_heads=16),
    "gpt3-760m": dict(num_layers=24, hidden_size=1536, num_heads=16),
    "gpt3-1.3b": dict(num_layers=24, hidden_size=2048, num_heads=16),
    "gpt3-2.7b": dict(num_layers=32, hidden_size=2560, num_heads=32),
    "gpt3-6.7b": dict(num_layers=32, hidden_size=4096, num_heads=32),
    "gpt3-13b": dict(num_layers=40, hidden_size=5120, num_heads=40),
    "gpt3-175b": dict(num_layers=96, hidden_size=12288, num_heads=96),
}


def gpt_config(name: str, **overrides) -> GPTConfig:
    if name not in GPT_CONFIGS:
        raise KeyError(f"unknown GPT config {name!r}; have {sorted(GPT_CONFIGS)}")
    return GPTConfig(**{**GPT_CONFIGS[name], **overrides})


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rotary_sincos(seq_len: int, head_dim: int, theta: float = 10000.0,
                  device=None):
    """``[S, D/2]`` float32 sin/cos tables."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """x: ``[B, S, H, D]``; sin/cos: ``[S, D/2]`` (broadcast over batch
    and heads)."""
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[None, :, None, :].to(x.dtype)
    cos = cos[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# Attention dispatch
# ---------------------------------------------------------------------------
def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, impl: str = "dense",
                                causal: bool = True,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Route ``[B, S, H, D]`` attention to the dense path or the flash
    kernels.  The ring and Ulysses schemes shard the sequence over
    devices and are not ported."""
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "dense":
        return F.scaled_dot_product_attention(q, k, v, causal=causal,
                                              scale=scale)
    if impl in _MULTI_DEVICE_ATTN:
        raise NotImplementedError(
            f"attn_impl={impl!r} is multi-GPU sequence parallelism, not "
            f"ported yet")
    raise ValueError(f"unknown attn_impl {impl!r}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class GPTEmbedding(nn.Module):
    """Token embedding + (optional) learned positions."""

    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, std=cfg.init_std,
            device=device, dtype=dtype, generator=generator)
        if cfg.use_rotary:
            self.position_embeddings = None
        else:
            self.position_embeddings = normal_parameter(
                (cfg.max_seq_len, cfg.hidden_size), cfg.init_std,
                device=device, dtype=dtype, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = self.word_embeddings(ids)
        if self.position_embeddings is not None:
            s = ids.shape[-1]
            h = h + self.position_embeddings[:s].to(h.dtype)
        return h


class GPTAttention(nn.Module):
    """Fused-QKV attention; the QKV columns are laid out ``[h, 3, d]``."""

    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = ColumnParallelLinear(h, 3 * h, std=cfg.init_std,
                                        device=device, dtype=dtype,
                                        generator=generator)
        self.out = RowParallelLinear(
            h, h, std=cfg.init_std / math.sqrt(2 * cfg.num_layers),
            device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, cfg.num_heads, 3, cfg.head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if cfg.use_rotary:
            sin, cos = rotary_sincos(s, cfg.head_dim, cfg.rope_theta,
                                     device=x.device)
            q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
        o = sequence_parallel_attention(q, k, v, impl=cfg.attn_impl,
                                        causal=True)
        return self.out(o.reshape(b, s, cfg.hidden_size))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.d_ffn,
                                        std=cfg.init_std, device=device,
                                        dtype=dtype, generator=generator)
        self.fc2 = RowParallelLinear(
            cfg.d_ffn, cfg.hidden_size,
            std=cfg.init_std / math.sqrt(2 * cfg.num_layers),
            device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu}[self.cfg.activation]
        return self.fc2(act(self.fc1(x)))


class GPTBlock(nn.Module):
    """Pre-LN transformer block with a dense FFN."""

    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.ln_epsilon, device=device,
                             dtype=dtype)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.ln_epsilon, device=device,
                             dtype=dtype)
        self.attn = GPTAttention(cfg, device=device, dtype=dtype,
                                 generator=generator)
        self.mlp = GPTMLP(cfg, device=device, dtype=dtype,
                          generator=generator)

    def forward_with_aux(self, x: torch.Tensor):
        """``(y, aux)``; a dense FFN's aux loss is a float32 zero."""
        h = x + self.attn(self.ln1(x))
        y = h + self.mlp(self.ln2(h))
        return y, torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.forward_with_aux(x)
        return y


class GPTHead(nn.Module):
    """Final norm + LM projection.  A tied head stores no projection:
    ``forward`` receives the embedding weight."""

    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        self.norm = LayerNorm(cfg.hidden_size, cfg.ln_epsilon, device=device,
                              dtype=dtype)
        if cfg.tie_embeddings:
            self.proj = None
        else:
            self.proj = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False,
                std=cfg.init_std, device=device, dtype=dtype,
                generator=generator)

    def forward(self, h: torch.Tensor,
                embed_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm(h)
        if self.proj is not None:
            return self.proj(h)
        if embed_weight is None:
            raise ValueError("tied head needs the embedding weight")
        return torch.matmul(h, embed_weight.to(h.dtype).T)


class GPT(nn.Module):
    """Decoder-only LM.  ``forward(ids [B, S]) -> logits [B, S, V]``."""

    def __init__(self, cfg: GPTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("num_heads must divide hidden_size")
        _check_config(cfg)
        device = resolve_device(device)
        dtype = _dt.canonicalize_dtype(cfg.dtype)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embedding = GPTEmbedding(cfg, **kw)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.head = GPTHead(cfg, **kw)
        self.loss_helper = ParallelCrossEntropy()

    # read off the final norm, which int8 decode copies keep as it is
    @property
    def device(self) -> torch.device:
        return self.head.norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.head.norm.weight.dtype

    def _embed_weight(self) -> Optional[torch.Tensor]:
        return (self.embedding.word_embeddings.weight
                if self.cfg.tie_embeddings else None)

    def _remat_wrap(self, fn):
        """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` and
        grad is on (policy ``"none"``: the block's activations are all
        recomputed in the backward); ``fn`` itself otherwise."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn
        return lambda *a: torch.utils.checkpoint.checkpoint(
            fn, *a, use_reentrant=False)

    def _run_blocks(self, h: torch.Tensor):
        fwd = self._remat_wrap(lambda blk, x: blk.forward_with_aux(x))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk in self.blocks:
            h, a = fwd(blk, h)
            aux = aux + a
        return h, aux

    def _hidden_states(self, ids: torch.Tensor):
        """Embedding + blocks -> (pre-head hidden, aux)."""
        return self._run_blocks(self.embedding(ids))

    def forward_with_aux(self, ids: torch.Tensor, rng=None):
        """``(logits [B, S, V], aux)``.  ``rng`` is the JAX signature's
        dropout key; with dropout 0 it is unused."""
        h, aux = self._hidden_states(ids)
        return self.head(h, self._embed_weight()), aux

    def forward(self, ids: torch.Tensor, rng=None) -> torch.Tensor:
        logits, _ = self.forward_with_aux(ids, rng)
        return logits

    def generate(self, ids, max_new_tokens: int, **kw) -> torch.Tensor:
        """KV-cache autoregressive decoding (see
        :func:`.generation.generate`)."""
        from .generation import generate
        return generate(self, ids, max_new_tokens, **kw)

    def loss(self, ids: torch.Tensor, labels: torch.Tensor, rng=None,
             ignore_index: int = -100) -> torch.Tensor:
        """Mean causal-LM loss over the labels that are not
        ``ignore_index``: ``sum(per_tok * valid) / max(sum(valid), 1)``,
        float32."""
        logits, _ = self.forward_with_aux(ids, rng)
        per_tok = self.loss_helper(logits, labels)              # [B, S]
        valid = (labels != ignore_index).to(per_tok.dtype)
        denom = torch.clamp(valid.sum(), min=1.0)
        return (per_tok * valid).sum() / denom


def _check_config(cfg: GPTConfig) -> None:
    """Raise on what the port does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError("MoE GPT blocks are not ported yet")
    if cfg.dropout > 0.0:
        raise NotImplementedError(
            "dropout > 0 is not ported yet: it waits for JAX's key path "
            "through _hidden_states and _run_blocks (one key for the "
            "embedding, one a block, two inside each block)")
    if cfg.attn_impl in _MULTI_DEVICE_ATTN:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is multi-GPU sequence "
            f"parallelism, not ported yet")
    if cfg.attn_impl not in ("dense", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.remat and cfg.remat_policy != "none":
        if cfg.remat_policy in ("dots", "dots_attn"):
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet")
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    if cfg.ce_chunk > 0:
        raise NotImplementedError("chunked cross-entropy (ce_chunk > 0) "
                                  "is not ported yet")


def build_gpt(cfg_or_name, *, device=None, dtype=None,
              generator: Optional[torch.Generator] = None,
              **overrides) -> GPT:
    """A GPT from a preset name or a :class:`GPTConfig`, with random
    weights drawn from ``generator`` (default: a generator on ``device``
    seeded with 0).  ``device`` defaults to CUDA (raises without one)."""
    if dtype is not None:
        overrides["dtype"] = dtype
    cfg = (gpt_config(cfg_or_name, **overrides)
           if isinstance(cfg_or_name, str)
           else dataclasses.replace(cfg_or_name, **overrides))
    with torch.no_grad():
        return GPT(cfg, device=device, generator=generator)


def gpt_loss_fn(model: GPT, batch, rng=None) -> torch.Tensor:
    """``loss_fn`` for :func:`..parallel.api.build_train_step`.
    ``batch = (ids, labels)``."""
    ids, labels = batch
    return model.loss(ids, labels, rng)
