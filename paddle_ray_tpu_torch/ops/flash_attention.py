"""Flash attention: blockwise exact attention with a recompute backward
(the port of ``paddle_ray_tpu/ops/flash_attention.py``).

The forward keeps a running max and denominator per query row and never
writes the ``[S, Skv]`` score matrix to device memory; it saves the output
and the natural-log logsumexp ``lse`` of each row.  The backward
recomputes the probabilities from ``lse``: one kernel computes ``dq``,
another ``dk`` and ``dv`` summed over the query heads that share a KV head
(GQA).  The arithmetic is the JAX kernels': q is pre-scaled in its own
dtype by ``scale * log2(e)`` and the kernels work in the exp2 domain,
masked logits are ``-1e30`` before the max, the causal mask is top-left
aligned (``row >= col``; it agrees with the dense path's bottom-right mask
only when ``S == Skv``), ``l`` is clamped to ``1e-30``.  An additive
float32 bias enters as ``bias * log2(e)``, before the causal mask and the
segment-id mask (``_mask_block``); a boolean ``attn_mask`` becomes a
``-1e30`` bias that gets no gradient.  ``dbias`` is the dq kernel's
``ds``, summed back to the bias's shape by autograd.

Three functions dispatch by device, one per kernel of
``csrc/flash_attention.cu``: :func:`flash_forward`,
:func:`flash_backward_dq` and :func:`flash_backward_dkv`.  For CUDA
tensors they launch the kernel and count the launch in their
``launches``; for CPU tensors they run the plain versions
(:func:`flash_forward_plain`, :func:`flash_backward_dq_plain`,
:func:`flash_backward_dkv_plain`).  There is no fallback between the two:
a CUDA tensor the kernel does not take raises.  These work on the folded
layout ``[B*H, S, D]`` (k and v ``[B*Hkv, Skv, D]``), with an optional
float32 ``bias`` of shape ``[B, H, S, Skv]`` (an ``expand``-ed view: the
kernels read it through its strides, so a broadcast mask is never
materialised) and optional ``segment_ids = (segq [B, S], segk [B, Skv])``
int32; :func:`flash_attention` is the differentiable ``[B, S, H, D]``
entry.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_forward", "flash_backward",
           "flash_backward_dq", "flash_backward_dkv", "flash_forward_plain",
           "flash_backward_dq_plain", "flash_backward_dkv_plain"]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

# what the CUDA kernels are built for: 64 x 64 tiles, these head dims
KERNEL_BLOCK = 64
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, S, H, D] -> contiguous [B*H, S, D]
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _pick_blocks(seq_len: int, kv_len: int, block_q: int,
                 block_k: int) -> Tuple[int, int]:
    bq = min(block_q, seq_len)
    bk = min(block_k, kv_len)
    if seq_len % bq or kv_len % bk:
        raise ValueError(
            f"seq lens ({seq_len},{kv_len}) must be divisible by block "
            f"sizes ({bq},{bk})")
    return bq, bk


def _prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # fold scale and the exp -> exp2 conversion into one multiply, rounded
    # to q's dtype as the JAX wrapper does
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the yardstick of the kernels
# ---------------------------------------------------------------------------
def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    if q.shape[0] % k.shape[0]:
        raise ValueError(f"q heads {q.shape[0]} not a multiple of kv heads "
                         f"{k.shape[0]}")
    return q.shape[0] // k.shape[0]


def _expand(x: torch.Tensor, group: int) -> torch.Tensor:
    """``[B*Hkv, Skv, D]`` -> float32 ``[B*H, Skv, D]``, each KV head
    repeated for the query heads of its group."""
    return x.float().repeat_interleave(group, dim=0)


def _seg_rows(seg: Optional[Tuple[torch.Tensor, torch.Tensor]],
              bh: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(segq, segk)`` of ``[B, S]`` / ``[B, Skv]`` repeated for the
    ``bh // B`` heads of each batch: ``[B*H, S]`` / ``[B*H, Skv]``."""
    if seg is None:
        return None
    segq, segk = seg
    h = bh // segq.shape[0]
    return segq.repeat_interleave(h, 0), segk.repeat_interleave(h, 0)


def _logits(qs: torch.Tensor, kf: torch.Tensor, causal: bool,
            bias: Optional[torch.Tensor] = None,
            seg: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> torch.Tensor:
    """float32 ``qs @ kf^T`` (exp2 domain) ``+ bias * log2(e)``, then the
    causal entries ``row < col`` and the entries of unequal segment ids
    set to -1e30 (the JAX ``_mask_block`` order).  Causal, the keys of
    the 64-key tiles past a row's own tile are ``-inf``: the kernels, as
    the JAX ones, never visit them, which matters only to a row whose
    every visible key is masked."""
    s = torch.matmul(qs.float(), kf.transpose(1, 2))
    if bias is not None:
        s = s + bias.reshape(s.shape) * _LOG2E
    if causal:
        rows = torch.arange(s.shape[1], device=s.device)[:, None]
        cols = torch.arange(s.shape[2], device=s.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    seg = _seg_rows(seg, s.shape[0])
    if seg is not None:
        s = s.masked_fill(seg[0][:, :, None] != seg[1][:, None, :], _NEG_INF)
    if causal:
        unvisited = cols >= (rows // KERNEL_BLOCK + 1) * KERNEL_BLOCK
        s = s.masked_fill(unvisited, float("-inf"))
    return s


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, scale: float,
                        bias: Optional[torch.Tensor] = None,
                        segment_ids=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: ``(o [B*H, S, D] in q's dtype, lse [B*H, S]
    float32)``, the whole score matrix at once.  The row max starts at
    -1e30 as the kernels' running max does, so a row masked to -1e30 by
    segment ids averages its values and one masked by a -1e30 bias
    gives zeros, as in JAX."""
    g = _group(q, k)
    s = _logits(_prescale_q(q, scale), _expand(k, g), causal, bias,
                segment_ids)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, _expand(v, g)) / l
    lse = ((m + torch.log2(l)) * _LN2)[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, v, do, lse, delta, causal, scale, bias, seg):
    """Recomputed ``p`` and ``ds = p * (do v^T - delta)``, float32
    ``[B*H, S, Skv]``, and the pre-scaled q."""
    g = _group(q, k)
    qs = _prescale_q(q, scale)
    p = torch.exp2(_logits(qs, _expand(k, g), causal, bias, seg)
                   - lse[..., None] * _LOG2E)
    dp = torch.matmul(do.float(), _expand(v, g).transpose(1, 2))
    return p, p * (dp - delta[..., None]), qs


def flash_backward_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                            scale: float, bias: Optional[torch.Tensor] = None,
                            segment_ids=None, need_dbias: bool = False):
    """Plain PyTorch dq: ``(sum ds k) * scale`` in q's dtype; with
    ``need_dbias``, ``(dq, dbias)``, dbias the float32 ``ds [B*H, S,
    Skv]``."""
    _, ds, _ = _probs(q, k, v, do, lse, delta, causal, scale, bias,
                      segment_ids)
    dq = (torch.matmul(ds, _expand(k, _group(q, k))) * scale).to(q.dtype)
    return (dq, ds) if need_dbias else dq


def flash_backward_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                             scale: float, bias: Optional[torch.Tensor] = None,
                             segment_ids=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dk, dv: ``dv = sum p^T do``, ``dk = (sum ds^T
    q_prescaled) * ln 2``, each summed over the q heads of a KV head."""
    g = _group(q, k)
    p, ds, qs = _probs(q, k, v, do, lse, delta, causal, scale, bias,
                       segment_ids)
    bhk, skv, d = k.shape
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dk = torch.matmul(ds.transpose(1, 2), qs.float())
    dv = dv.reshape(bhk, g, skv, d).sum(1)
    dk = dk.reshape(bhk, g, skv, d).sum(1) * _LN2
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(q, k, v, *rest) -> None:
    """Raise on anything the CUDA kernels do not take.  ``rest`` are the
    backward's ``do`` ([B*H, S, D], q's dtype), ``lse`` and ``delta``
    ([B*H, S] float32)."""
    dev = q.device
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q [BH, S, D], k = v [BHkv, Skv, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    _group(q, k)
    if k.shape[2] != d:
        raise ValueError(f"head_dim mismatch: q {d}, k {k.shape[2]}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim {d} not in {KERNEL_HEAD_DIMS}")
    _pick_blocks(s, k.shape[1], KERNEL_BLOCK, KERNEL_BLOCK)
    tensors = [("q", q), ("k", k), ("v", v)]
    if rest:
        do, lse, delta = rest
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
        for name, t in (("lse", lse), ("delta", delta)):
            if t.shape != (bh, s) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [{bh}, {s}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        tensors += [("do", do), ("lse", lse), ("delta", delta)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _extras(q: torch.Tensor, k: torch.Tensor,
            bias: Optional[torch.Tensor], seg) -> tuple:
    """The kernels' bias and segment-id arguments: ``(bias pointer, its
    four strides, heads, segq pointer, segk pointer)``, each checked."""
    bh, s, _ = q.shape
    skv = k.shape[1]
    heads = None
    if bias is not None:
        if bias.dim() != 4 or bias.shape[2:] != (s, skv) or \
                bias.shape[0] * bias.shape[1] != bh:
            raise ValueError(f"bias must be [B, H, {s}, {skv}] with B * H = "
                             f"{bh}, got {tuple(bias.shape)}")
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise ValueError(f"bias must be float32 on {q.device}, got "
                             f"{bias.dtype} on {bias.device}")
        heads = bias.shape[1]
    if seg is not None:
        segq, segk = seg
        b = segq.shape[0]
        for name, t, n in (("segq", segq, s), ("segk", segk, skv)):
            if (t.shape != (b, n) or t.dtype != torch.int32
                    or t.device != q.device or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous int32 [{b}, "
                                 f"{n}] on {q.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if b == 0 or bh % b or (heads is not None and heads != bh // b):
            raise ValueError(f"segment ids of batch {b} do not fit {bh} "
                             f"heads (bias heads {heads})")
        heads = bh // b
    return ((None, 0, 0, 0, 0) if bias is None
            else (bias.data_ptr(), *bias.stride())) + (
        heads or 1,
        None if seg is None else seg[0].data_ptr(),
        None if seg is None else seg[1].data_ptr())


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.prt_flash_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        extras = [p] + [ll] * 4 + [i, p, p]
        lib.prt_flash_fwd.argtypes = [p] * 5 + [i] * 7 + extras + [p]
        lib.prt_flash_bwd_dq.argtypes = ([p] * 8 + [i] * 5 + [ctypes.c_float]
                                         + [i] * 2 + extras + [p])
        lib.prt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + extras + [p]
        for fn in (lib.prt_flash_fwd, lib.prt_flash_bwd_dq,
                   lib.prt_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.prt_flash_error_string.argtypes = [ctypes.c_int]
        lib.prt_flash_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, device: torch.device, *args) -> None:
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.prt_flash_error_string(err).decode()})")


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    return q.device.type


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float,
                  bias: Optional[torch.Tensor] = None, segment_ids=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on the folded layout: q ``[B*H, S, D]``, k/v ``[B*Hkv, Skv,
    D]`` -> ``(o [B*H, S, D] in q's dtype, lse [B*H, S] float32)``."""
    if _device(q) == "cpu":
        return flash_forward_plain(q, k, v, causal=causal, scale=scale,
                                   bias=bias, segment_ids=segment_ids)
    _check_cuda(q, k, v)
    extras = _extras(q, k, bias, segment_ids)
    bh, s, d = q.shape
    bhk, skv, _ = k.shape
    qs = _prescale_q(q, scale)
    o = torch.empty_like(qs)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "prt_flash_fwd", q.device,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, bhk, s, skv, d, int(causal),
            _KERNEL_DTYPES[q.dtype], *extras)
    flash_forward.launches += 1
    return o, lse


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                      scale: float, bias: Optional[torch.Tensor] = None,
                      segment_ids=None, need_dbias: bool = False):
    """dq on the folded layout, from the forward's ``lse`` and ``delta =
    sum(o * do, -1)`` (float32 ``[B*H, S]``); with ``need_dbias``,
    ``(dq, dbias)``, dbias float32 ``[B*H, S, Skv]`` written by the same
    kernel."""
    if _device(q) == "cpu":
        return flash_backward_dq_plain(q, k, v, do, lse, delta,
                                       causal=causal, scale=scale, bias=bias,
                                       segment_ids=segment_ids,
                                       need_dbias=need_dbias)
    _check_cuda(q, k, v, do, lse, delta)
    extras = _extras(q, k, bias, segment_ids)
    bh, s, d = q.shape
    bhk, skv, _ = k.shape
    qs = _prescale_q(q, scale)
    dq = torch.empty_like(qs)
    dbias = (torch.empty(bh, s, skv, dtype=torch.float32, device=q.device)
             if need_dbias else None)
    _launch("flash_attention_bwd_dq", "prt_flash_bwd_dq", q.device,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            None if dbias is None else dbias.data_ptr(), bh, bhk, s, skv, d,
            scale, int(causal), _KERNEL_DTYPES[q.dtype], *extras)
    flash_backward_dq.launches += 1
    return (dq, dbias) if need_dbias else dq


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                       scale: float, bias: Optional[torch.Tensor] = None,
                       segment_ids=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv on the folded layout (k's shape and dtype), summed over
    the q heads of each KV head."""
    if _device(q) == "cpu":
        return flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                        causal=causal, scale=scale,
                                        bias=bias, segment_ids=segment_ids)
    _check_cuda(q, k, v, do, lse, delta)
    extras = _extras(q, k, bias, segment_ids)
    bh, s, d = q.shape
    bhk, skv, _ = k.shape
    qs = _prescale_q(q, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", "prt_flash_bwd_dkv", q.device,
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, bhk, s, skv, d, int(causal), _KERNEL_DTYPES[q.dtype],
            *extras)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_backward(q, k, v, o, lse, do, *, causal: bool = True,
                   scale: float, bias: Optional[torch.Tensor] = None,
                   segment_ids=None, need_dbias: bool = False):
    """``(dq, dk, dv)`` on the folded layout, and ``dbias`` last with
    ``need_dbias``.  ``delta = sum(o * do, -1)`` in float32 is a plain op,
    as in the JAX package; then the dq kernel and the dk/dv kernel."""
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, scale=scale, bias=bias, segment_ids=segment_ids)
    dq = flash_backward_dq(q, k, v, do, lse, delta, need_dbias=need_dbias,
                           **kw)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    if need_dbias:
        dq, dbias = dq
        return dq, dk, dv, dbias
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Folded-layout attention whose backward is the two backward kernels;
    saves q, k, v, o and lse (the JAX custom VJP's residuals) and the bias
    and segment ids.  dbias is computed only when the bias needs a
    gradient; autograd sums it back through the bias's ``expand``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segq, segk, causal: bool, scale: float):
        seg = None if segq is None else (segq, segk)
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                               bias=bias, segment_ids=seg)
        ctx.save_for_backward(q, k, v, o, lse, bias, segq, segk)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, segq, segk = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        out = flash_backward(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale, bias=bias,
            segment_ids=None if segq is None else (segq, segk),
            need_dbias=need_dbias)
        dbias = out[3].reshape(bias.shape) if need_dbias else None
        return out[0], out[1], out[2], dbias, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None,
                    attn_mask: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise exact attention, differentiable.  q ``[B, S, H, D]``;
    k/v ``[B, Skv, Hkv, D]`` with ``H % Hkv == 0`` (GQA/MQA) -> ``[B, S,
    H, D]`` in q's dtype.

    ``bias``: additive score bias broadcastable to ``[B, H, S, Skv]``,
    differentiable (its gradient in float32, cast to its dtype).
    ``attn_mask``: boolean, broadcastable to ``[B, H, S, Skv]``; False
    positions become a ``-1e30`` bias with no gradient.  Both reach the
    kernels as an ``expand``-ed view, never materialised.
    ``segment_ids`` (``[B, S]`` int): attention only within equal ids
    (padded batches, packed sequences); ``kv_segment_ids`` defaults to
    ``segment_ids`` and, as in JAX, is ignored without it.
    ``block_q``/``block_k`` (default 64, the CUDA kernels' tile) are
    checked as the JAX wrapper checks them: S and Skv must be divisible
    by ``min(block, len)``.
    """
    b, s, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    _pick_blocks(s, skv, block_q or KERNEL_BLOCK, block_k or KERNEL_BLOCK)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if attn_mask is not None:
        mask_bias = torch.where(
            attn_mask.to(device=q.device, dtype=torch.bool),
            torch.zeros((), dtype=torch.float32, device=q.device),
            torch.full((), _NEG_INF, dtype=torch.float32, device=q.device))
        bias = mask_bias if bias is None else bias.float() + mask_bias
    if bias is not None:
        bias = bias.float().expand(b, h, s, skv)
    segq = segk = None
    if segment_ids is not None:
        segq = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        segk = (segq if kv_segment_ids is None else kv_segment_ids.to(
            device=q.device, dtype=torch.int32).contiguous())
    o = _Flash.apply(_fold_heads(q), _fold_heads(k), _fold_heads(v), bias,
                     segq, segk, causal, scale)
    return _unfold_heads(o, b, h)
