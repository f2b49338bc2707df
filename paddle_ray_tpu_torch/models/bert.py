"""BERT / ERNIE-style encoder with MLM + NSP pretraining heads (the port's
counterpart of ``paddle_ray_tpu/models/bert.py``).

Same configuration table, module tree and parameter names (a JAX state
dict maps over with one renaming, see :mod:`..weights`), same arithmetic:
post-LN encoder layers with the fused QKV laid out ``(b, s, heads, 3,
dh)``, tanh GELU, float32 LayerNorm (epsilon 1e-12), the MLM decoder tied
to the word embeddings, NSP on the tanh pooler, and the init standard
deviations of the JAX file (the output projections' scaled by ``1 /
sqrt(2 L)``; pooler and heads xavier-uniform).  Attention is dense (a
``[B, 1, 1, S]`` boolean padding mask) or flash, where the padding mask
becomes segment ids (valid 1, pad 0) for the CUDA kernels.  Dropout, as
in JAX, is the embeddings' only, and only when a key is passed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from ..core import dtypes as _dt
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, Linear
from ..ops.flash_attention import flash_attention
from ..parallel.tp import (ColumnParallelLinear, ParallelCrossEntropy,
                           RowParallelLinear, VocabParallelEmbedding,
                           normal_parameter)

__all__ = ["BertConfig", "BERT_CONFIGS", "bert_config", "BertEmbeddings",
           "BertLayer", "Bert", "BertForPretraining", "bert_pretrain_loss_fn"]


@dataclasses.dataclass
class BertConfig:
    attn_impl: str = "dense"          # dense | flash (padding via segment ids)
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    dropout: float = 0.0
    activation: str = "gelu"
    init_std: float = 0.02
    ln_epsilon: float = 1e-12
    dtype: Any = None                 # parameter dtype (default float32)

    @property
    def d_ffn(self) -> int:
        return self.ffn_hidden or 4 * self.hidden_size


BERT_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_layers=12, num_heads=12),
    "bert-large": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "ernie-3.0-medium": dict(hidden_size=768, num_layers=6, num_heads=12),
    "ernie-3.0-base": dict(hidden_size=768, num_layers=12, num_heads=12),
}


def bert_config(name: str, **overrides) -> BertConfig:
    if name not in BERT_CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(BERT_CONFIGS)}")
    return BertConfig(**{**BERT_CONFIGS[name], **overrides})


class BertEmbeddings(nn.Module):
    """Word + learned position + token-type embeddings, LayerNorm, and
    dropout when the config has it and a key is passed."""

    def __init__(self, cfg: BertConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        std = cfg.init_std
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, std=std, **kw)
        self.position_embeddings = normal_parameter(
            (cfg.max_seq_len, cfg.hidden_size), std, **kw)
        self.token_type_embeddings = normal_parameter(
            (cfg.type_vocab_size, cfg.hidden_size), std, **kw)
        self.norm = LayerNorm(cfg.hidden_size, cfg.ln_epsilon, device=device,
                              dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                rng=None) -> torch.Tensor:
        s = ids.shape[-1]
        h = self.word_embeddings(ids)
        h = h + self.position_embeddings[None, :s].to(h.dtype)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        h = h + self.token_type_embeddings.to(h.dtype)[token_type_ids]
        h = self.norm(h)
        if self.cfg.dropout > 0.0 and rng is not None:
            h = self.dropout(h, rng=rng)
        return h


class BertLayer(nn.Module):
    """Post-LN encoder layer; QKV columns laid out ``[heads, 3, dh]``."""

    def __init__(self, cfg: BertConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        out_std = cfg.init_std / math.sqrt(2 * cfg.num_layers)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = ColumnParallelLinear(h, 3 * h, std=cfg.init_std, **kw)
        self.attn_out = RowParallelLinear(h, h, std=out_std, **kw)
        self.attn_norm = LayerNorm(h, cfg.ln_epsilon, device=device,
                                   dtype=dtype)
        self.fc1 = ColumnParallelLinear(h, cfg.d_ffn, std=cfg.init_std, **kw)
        self.fc2 = RowParallelLinear(cfg.d_ffn, h, std=out_std, **kw)
        self.ffn_norm = LayerNorm(h, cfg.ln_epsilon, device=device,
                                  dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, hdim = x.shape
        dh = hdim // cfg.num_heads
        qkv = self.qkv(x).reshape(b, s, cfg.num_heads, 3, dh)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if cfg.attn_impl == "flash":
            a = flash_attention(q, k, v, causal=False,
                                segment_ids=segment_ids)
        else:
            a = F.scaled_dot_product_attention(q, k, v, mask=mask,
                                               causal=False)
        x = self.attn_norm(x + self.attn_out(a.reshape(b, s, hdim)))
        act = {"gelu": F.gelu, "relu": F.relu}[cfg.activation]
        return self.ffn_norm(x + self.fc2(act(self.fc1(x))))


def _check_config(cfg: BertConfig) -> None:
    if cfg.hidden_size % cfg.num_heads:
        raise ValueError("num_heads must divide hidden_size")
    if cfg.attn_impl not in ("dense", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.activation not in ("gelu", "relu"):
        raise ValueError(f"unknown activation {cfg.activation!r}")


class Bert(nn.Module):
    """Encoder: ``forward(ids, token_type_ids, attention_mask) ->
    (sequence_output, pooled_output)``."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        device = resolve_device(device)
        dtype = _dt.canonicalize_dtype(cfg.dtype)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.layers = nn.ModuleList([BertLayer(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, rng=None):
        mask = segment_ids = None
        if attention_mask is not None:
            # [B, S] 1/0 padding -> a [B, 1, 1, S] boolean mask (dense) or
            # segment ids, valid 1 and pad 0 (flash)
            mask = attention_mask[:, None, None, :].to(torch.bool)
            segment_ids = attention_mask.to(torch.int32)
        h = self.embeddings(ids, token_type_ids, rng)
        for layer in self.layers:
            h = layer(h, mask, segment_ids)
        pooled = F.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForPretraining(nn.Module):
    """MLM (tied decoder) + NSP heads."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        self.bert = Bert(cfg, device=device, generator=generator)
        dtype = _dt.canonicalize_dtype(cfg.dtype)
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.mlm_transform = Linear(h, h, **kw)
        self.mlm_norm = LayerNorm(h, cfg.ln_epsilon, device=device,
                                  dtype=dtype)
        self.nsp = Linear(h, 2, **kw)
        self.ce = ParallelCrossEntropy()

    def forward(self, ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, rng=None):
        """``(mlm_logits [B, S, V], nsp_logits [B, 2])``."""
        seq, pooled = self.bert(ids, token_type_ids, attention_mask, rng)
        t = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        mlm_logits = torch.matmul(t, w.to(t.dtype).T)
        return mlm_logits, self.nsp(pooled)

    def loss(self, batch, rng=None, ignore_index: int = -100) -> torch.Tensor:
        """``batch``: dict(ids, token_type_ids?, attention_mask?,
        mlm_labels, nsp_labels?).  The mean MLM loss over labels that are
        not ``ignore_index`` (``sum / max(count, 1)``), plus the NSP
        cross-entropy when NSP labels are given; float32."""
        mlm_logits, nsp_logits = self.forward(
            batch["ids"], batch.get("token_type_ids"),
            batch.get("attention_mask"), rng)
        labels = batch["mlm_labels"]
        per_tok = self.ce(mlm_logits, labels)
        valid = (labels != ignore_index).to(per_tok.dtype)
        loss = (per_tok * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        if batch.get("nsp_labels") is not None:
            loss = loss + F.cross_entropy(nsp_logits, batch["nsp_labels"])
        return loss


def bert_pretrain_loss_fn(model: BertForPretraining, batch,
                          rng=None) -> torch.Tensor:
    """``loss_fn`` for :func:`..parallel.api.build_train_step`."""
    return model.loss(batch, rng)
