"""GPT decoder-only transformer (the port's counterpart of
``paddle_ray_tpu/models/gpt.py``).

Same configuration table, same module tree and parameter names (so a JAX
state dict maps over key for key, see :mod:`..weights`), same arithmetic:
pre-LN blocks, fused QKV laid out ``[heads, (q|k|v), dim]``, tanh GELU,
float32 LayerNorm, tied LM head, and the causal-LM loss.  Attention is
dense or flash (the CUDA kernels of :mod:`..ops.flash_attention`).

Dropout follows JAX's key path bit for bit: ``rng`` is split into the
embedding's key and the blocks' key, that into one key a block, and each
block's into the attention output's and the MLP output's
(:func:`..core.prng.split`); without ``rng`` nothing is dropped, as in
JAX.  On CUDA each drop is the dropout kernel (:mod:`..ops.dropout`).

Remat wraps each block in ``torch.utils.checkpoint``: policy ``"none"``
recomputes the whole block in the backward; ``"dots"`` and ``"dots_attn"``
are JAX's ``dots_with_no_batch_dims_saveable`` and its union with the
names ``attn_out``, ``flash_out`` and ``flash_lse``, as selective
checkpoint policies (:func:`remat_policy`).  Draws from the key tracker
inside a block are replayed in the recompute
(:func:`..core.rng.checkpoint_contexts`).  ``ce_chunk > 0`` computes the
head and the loss a chunk of positions at a time, each chunk
checkpointed, so the ``[B, S, V]`` logits never exist whole.  The MoE FFN
and the multi-device attention schemes raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..amp.auto_cast import current_policy, policy_scope
from ..core import dtypes as _dt
from ..core import prng
from ..core import rng as _rng
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm
from ..ops.flash_attention import flash_attention
from ..parallel.tp import (ColumnParallelLinear, ParallelCrossEntropy,
                           RowParallelLinear, VocabParallelEmbedding,
                           normal_parameter)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPT", "GPTEmbedding",
           "GPTAttention", "GPTMLP", "GPTBlock", "GPTHead", "build_gpt",
           "gpt_loss_fn", "rotary_sincos", "apply_rotary",
           "sequence_parallel_attention", "checkpoint_name",
           "remat_policy"]

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
    remat_policy: str = "none"        # "none" | "dots" | "dots_attn"
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
    ce_chunk: int = 0                 # > 0: head + CE in chunks of positions

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
# Remat policies
# ---------------------------------------------------------------------------
_NAMES = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The counterpart of ``jax.ad_checkpoint.checkpoint_name``: the
    outputs of the operators run inside are named ``name`` for the remat
    policies."""
    prev = getattr(_NAMES, "name", None)
    _NAMES.name = name
    try:
        yield
    finally:
        _NAMES.name = prev


_aten = torch.ops.aten
# matrix products without batch dims (a linear layer's x @ W folds to mm)
_DOTS = (_aten.mm.default, _aten.addmm.default)
# the flash forward: both its outputs, "flash_out" and "flash_lse"
_FLASH = torch.ops.prt.flash_attention_fwd.default
_DOTS_ATTN_NAMES = ("attn_out",)


def _policy_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _policy_dots_attn(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if (op in _DOTS or op == _FLASH
            or getattr(_NAMES, "name", None) in _DOTS_ATTN_NAMES):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"none": None, "dots": _policy_dots,
             "dots_attn": _policy_dots_attn}


def remat_policy(name: str):
    """The selective-checkpoint policy of a ``remat_policy`` name (None
    for ``"none"``: everything recomputed).  ``"dots"`` saves the outputs
    of ``aten.mm`` / ``aten.addmm`` (JAX's
    ``dots_with_no_batch_dims_saveable``: the four projections, not the
    batched products of dense attention; the flash forward is
    recomputed, as a ``pallas_call`` is no dot in JAX); ``"dots_attn"``
    also the flash operator's ``o`` and ``lse`` and what runs under
    ``checkpoint_name("attn_out")``."""
    if name not in _POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}")
    return _POLICIES[name]


@contextlib.contextmanager
def _entered(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


def _remat_contexts(policy):
    """``context_fn`` of the block checkpoint: the key tracker's replay,
    the AMP policy of the forward re-entered in the recompute and, with a
    policy, the selective-checkpoint contexts."""
    fwd, rec = _rng.checkpoint_contexts()
    rec = _entered(rec, policy_scope(current_policy()))
    if policy is None:
        return fwd, rec
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    sac_fwd, sac_rec = create_selective_checkpoint_contexts(policy)
    return _entered(fwd, sac_fwd), _entered(rec, sac_rec)


def remat(fn, policy_name: str = "none"):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) with the
    named policy; key-tracker draws inside are replayed in the
    recompute.  torch's own RNG state is not stashed: the port draws no
    random number from it."""
    policy = remat_policy(policy_name)
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: _remat_contexts(policy))


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
        self.dropout = Dropout(cfg.dropout)

    def forward(self, ids: torch.Tensor, rng=None) -> torch.Tensor:
        h = self.word_embeddings(ids)
        if self.position_embeddings is not None:
            s = ids.shape[-1]
            h = h + self.position_embeddings[:s].to(h.dtype)
        if self.cfg.dropout > 0.0 and rng is not None:
            h = self.dropout(h, rng=rng)
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

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
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
        # named for the "dots_attn" policy, as in JAX
        with checkpoint_name("attn_out"):
            o = o.reshape(b, s, cfg.hidden_size)
        return self.out(o)


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
        self.dropout = Dropout(cfg.dropout)

    def forward_with_aux(self, x: torch.Tensor, rng=None):
        """``(y, aux)``; a dense FFN's aux loss is a float32 zero.  ``rng``
        splits into the keys of the attention output's and the MLP
        output's dropout."""
        cfg = self.cfg
        r1, r2 = (None, None) if rng is None else tuple(prng.split(rng))
        a = self.attn(self.ln1(x), rng=r1)
        if cfg.dropout > 0.0 and r1 is not None:
            a = self.dropout(a, rng=r1)
        h = x + a
        m = self.mlp(self.ln2(h))
        if cfg.dropout > 0.0 and r2 is not None:
            m = self.dropout(m, rng=r2)
        y = h + m
        return y, torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        y, _ = self.forward_with_aux(x, rng)
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
        """``fn`` under :func:`remat` with ``cfg.remat_policy`` when
        ``cfg.remat`` and grad is on; ``fn`` itself otherwise."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn
        return remat(fn, self.cfg.remat_policy)

    def _run_blocks(self, h: torch.Tensor, rng=None):
        keys = ([None] * len(self.blocks) if rng is None
                else list(prng.split(rng, len(self.blocks))))
        fwd = self._remat_wrap(lambda blk, x, r: blk.forward_with_aux(x, r))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk, k in zip(self.blocks, keys):
            h, a = fwd(blk, h, k)
            aux = aux + a
        return h, aux

    def _hidden_states(self, ids: torch.Tensor, rng=None):
        """Embedding + blocks -> (pre-head hidden, aux): the shared prefix
        of the full-logits and chunked-CE paths."""
        r0 = None
        if rng is not None:
            rng, r0 = prng.split(rng)
        return self._run_blocks(self.embedding(ids, rng=r0), rng)

    def forward_with_aux(self, ids: torch.Tensor, rng=None):
        """``(logits [B, S, V], aux)``; ``rng`` is the dropout key."""
        h, aux = self._hidden_states(ids, rng)
        return self.head(h, self._embed_weight()), aux

    def forward(self, ids: torch.Tensor, rng=None) -> torch.Tensor:
        logits, _ = self.forward_with_aux(ids, rng)
        return logits

    def generate(self, ids, max_new_tokens: int, **kw) -> torch.Tensor:
        """KV-cache autoregressive decoding (see
        :func:`.generation.generate`)."""
        from .generation import generate
        return generate(self, ids, max_new_tokens, **kw)

    def _chunked_head_ce(self, h: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int) -> torch.Tensor:
        """The head's norm once, then per chunk of ``ce_chunk`` positions
        the logits and the CE sum and valid count under
        ``torch.utils.checkpoint`` (recomputed in the backward), summed
        chunk after chunk in float32: the ``[B, S, V]`` logits never
        exist whole."""
        c = self.cfg.ce_chunk
        s_len = h.shape[1]
        if s_len % c:
            raise ValueError(f"seq {s_len} not divisible by ce_chunk {c}")
        h = self.head.norm(h)
        if self.head.proj is not None:
            w, bias = self.head.proj.weight, self.head.proj.bias    # [H, V]
        else:
            w, bias = self._embed_weight().T, None

        def chunk(hc, w, lc):
            logits = torch.matmul(hc, w.to(hc.dtype))
            if bias is not None:
                logits = logits + bias.to(logits.dtype)
            per = self.loss_helper(logits, lc)
            valid = (lc != ignore_index).to(per.dtype)
            return (per * valid).sum(), valid.sum()

        if torch.is_grad_enabled():
            plain = chunk
            chunk = lambda *a: torch.utils.checkpoint.checkpoint(  # noqa: E731
                plain, *a, use_reentrant=False, preserve_rng_state=False)
        s_sum = v_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s_len, c):
            cs, cv = chunk(h[:, i:i + c], w, labels[:, i:i + c])
            s_sum, v_sum = s_sum + cs, v_sum + cv
        return s_sum / torch.clamp(v_sum, min=1.0)

    def loss(self, ids: torch.Tensor, labels: torch.Tensor, rng=None,
             ignore_index: int = -100) -> torch.Tensor:
        """Mean causal-LM loss over the labels that are not
        ``ignore_index``: ``sum(per_tok * valid) / max(sum(valid), 1)``,
        float32 (with ``ce_chunk``, the sums chunk by chunk)."""
        if self.cfg.ce_chunk > 0:
            h, _ = self._hidden_states(ids, rng)
            return self._chunked_head_ce(h, labels, ignore_index)
        logits, _ = self.forward_with_aux(ids, rng)
        per_tok = self.loss_helper(logits, labels)              # [B, S]
        valid = (labels != ignore_index).to(per_tok.dtype)
        denom = torch.clamp(valid.sum(), min=1.0)
        return (per_tok * valid).sum() / denom


def _check_config(cfg: GPTConfig) -> None:
    """Raise on what the port does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError("MoE GPT blocks are not ported yet")
    if cfg.attn_impl in _MULTI_DEVICE_ATTN:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is multi-GPU sequence "
            f"parallelism, not ported yet")
    if cfg.attn_impl not in ("dense", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.remat:
        remat_policy(cfg.remat_policy)


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
    ``batch = (ids, labels)``; ``rng`` is the dropout key."""
    ids, labels = batch
    return model.loss(ids, labels, rng)
