"""Diffusion UNet, Stable-Diffusion style (the port's counterpart of
``paddle_ray_tpu/models/unet.py``): the conv2d / group-norm path.

NHWC activations throughout; every GroupNorm runs through the fused CUDA
kernels of :mod:`..ops.groupnorm` (with SiLU, and with the timestep
scale/shift in the ResBlocks); sinusoidal timestep embedding -> MLP ->
per-ResBlock scale/shift; self-attention (the plain dense attention of
:func:`..nn.functional.scaled_dot_product_attention`, as the JAX UNet
uses XLA's, not flash) at the levels in ``attn_levels``; skip-connected
down and up paths.  The module tree and parameter names are the JAX
ones: ``downs`` and ``ups`` are lists of dicts there and a ``ModuleList``
of ``ModuleDict`` here, so the state-dict keys agree
(``downs.0.res.conv1.weight``, ...) and :mod:`..weights` maps a JAX state
dict over as it is.  AttnBlock's qkv columns keep the JAX ``[heads, 3,
dh]`` layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..core import dtypes as _dt
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Conv2D, Conv2DTranspose, GroupNorm, Linear
from ..ops.groupnorm import fused_group_norm

__all__ = ["UNetConfig", "UNet", "ResBlock", "AttnBlock", "Downsample",
           "Upsample", "timestep_embedding", "build_unet", "unet_loss_fn"]


def _fgn(norm: GroupNorm, x: torch.Tensor, *, scale=None, shift=None,
         act: str = "none") -> torch.Tensor:
    """A GroupNorm module's parameters through the fused kernels."""
    return fused_group_norm(x, norm.weight, norm.bias,
                            groups=norm.num_groups, epsilon=norm.epsilon,
                            scale=scale, shift=shift, act=act)


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    blocks_per_level: int = 2
    attn_levels: Tuple[int, ...] = (2,)    # level indices with self-attn
    num_heads: int = 4
    groups: int = 32
    upsample: str = "interp"               # interp | deconv
    dtype: Any = None                      # parameter dtype (default float32)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[N] -> [N, dim]`` float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _gn(ch: int, groups: int, kw: dict) -> GroupNorm:
    return GroupNorm(min(groups, ch), ch, device=kw["device"],
                     dtype=kw["dtype"])


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + timestep scale/shift, residual."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int,
                 **kw):
        super().__init__()
        self.norm1 = _gn(cin, groups, kw)
        self.conv1 = Conv2D(cin, cout, 3, padding=1, **kw)
        self.temb_proj = Linear(temb_dim, 2 * cout, **kw)
        self.norm2 = _gn(cout, groups, kw)
        self.conv2 = Conv2D(cout, cout, 3, padding=1, **kw)
        self.skip = Conv2D(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_fgn(self.norm1, x, act="silu"))
        scale, shift = self.temb_proj(F.silu(temb)).to(h.dtype).chunk(2, -1)
        h = self.conv2(_fgn(self.norm2, h, scale=scale, shift=shift,
                            act="silu"))
        idn = x if self.skip is None else self.skip(x)
        return h + idn


class AttnBlock(nn.Module):
    """Spatial self-attention over the H*W tokens."""

    def __init__(self, ch: int, num_heads: int, groups: int, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.norm = _gn(ch, groups, kw)
        self.qkv = Linear(ch, 3 * ch, **kw)
        self.proj = Linear(ch, ch, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        dh = c // self.num_heads
        t = _fgn(self.norm, x).reshape(n, hh * ww, c)
        qkv = self.qkv(t).reshape(n, hh * ww, self.num_heads, 3, dh)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        a = F.scaled_dot_product_attention(q, k, v, causal=False)
        out = self.proj(a.reshape(n, hh * ww, c)).reshape(n, hh, ww, c)
        return x + out


class Downsample(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv = Conv2D(ch, ch, 3, stride=2, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """2x upsampling: ``"interp"`` is nearest x2 (each pixel repeated, as
    ``jax.image.resize(..., "nearest")`` does at x2) then a 3x3 conv;
    ``"deconv"`` a stride-2 transposed conv."""

    def __init__(self, ch: int, mode: str = "interp", **kw):
        super().__init__()
        if mode not in ("interp", "deconv"):
            raise ValueError(f"unknown upsample mode {mode!r}")
        self.mode = mode
        if mode == "deconv":
            self.conv = Conv2DTranspose(ch, ch, 4, stride=2, padding=1, **kw)
        else:
            self.conv = Conv2D(ch, ch, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "interp":
            n, h, w, c = x.shape
            x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
                n, 2 * h, 2 * w, c)
        return self.conv(x)


class UNet(nn.Module):
    """``forward(x [N, H, W, Cin], t [N]) -> [N, H, W, Cout]``."""

    def __init__(self, cfg: UNetConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = _dt.canonicalize_dtype(cfg.dtype)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        ch = cfg.base_channels
        temb = 4 * ch
        self.temb1 = Linear(ch, temb, **kw)
        self.temb2 = Linear(temb, temb, **kw)
        self.stem = Conv2D(cfg.in_channels, ch, 3, padding=1, **kw)

        downs, chans, cin = [], [ch], ch
        last = len(cfg.channel_mults) - 1
        for lvl, mult in enumerate(cfg.channel_mults):
            cout = ch * mult
            for _ in range(cfg.blocks_per_level):
                blk = {"res": ResBlock(cin, cout, temb, cfg.groups, **kw)}
                if lvl in cfg.attn_levels:
                    blk["attn"] = AttnBlock(cout, cfg.num_heads, cfg.groups,
                                            **kw)
                downs.append(nn.ModuleDict(blk))
                chans.append(cout)
                cin = cout
            if lvl != last:
                downs.append(nn.ModuleDict({"down": Downsample(cout, **kw)}))
                chans.append(cout)
        self.downs = nn.ModuleList(downs)

        self.mid1 = ResBlock(cin, cin, temb, cfg.groups, **kw)
        self.mid_attn = AttnBlock(cin, cfg.num_heads, cfg.groups, **kw)
        self.mid2 = ResBlock(cin, cin, temb, cfg.groups, **kw)

        ups = []
        for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
            cout = ch * mult
            for _ in range(cfg.blocks_per_level + 1):
                skip = chans.pop()
                blk = {"res": ResBlock(cin + skip, cout, temb, cfg.groups,
                                       **kw)}
                if lvl in cfg.attn_levels:
                    blk["attn"] = AttnBlock(cout, cfg.num_heads, cfg.groups,
                                            **kw)
                ups.append(nn.ModuleDict(blk))
                cin = cout
            if lvl != 0:
                ups.append(nn.ModuleDict({"up": Upsample(
                    cout, mode=cfg.upsample, **kw)}))
        self.ups = nn.ModuleList(ups)

        self.out_norm = _gn(cin, cfg.groups, kw)
        self.out_conv = Conv2D(cin, cfg.out_channels, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        temb = self.temb2(F.silu(self.temb1(
            timestep_embedding(t, cfg.base_channels).to(x.dtype))))
        h = self.stem(x)
        skips = [h]
        for blk in self.downs:
            if "down" in blk:
                h = blk["down"](h)
            else:
                h = blk["res"](h, temb)
                if "attn" in blk:
                    h = blk["attn"](h)
            skips.append(h)
        h = self.mid2(self.mid_attn(self.mid1(h, temb)), temb)
        for blk in self.ups:
            if "up" in blk:
                h = blk["up"](h)
            else:
                h = blk["res"](torch.cat([h, skips.pop()], dim=-1), temb)
                if "attn" in blk:
                    h = blk["attn"](h)
        return self.out_conv(_fgn(self.out_norm, h, act="silu"))


def build_unet(cfg: UNetConfig, *, device=None, dtype=None,
               generator: Optional[torch.Generator] = None) -> UNet:
    """A :class:`UNet` with random weights drawn from ``generator``
    (default: a generator on ``device`` seeded with 0); ``dtype``
    overrides ``cfg.dtype``.  ``device`` defaults to CUDA (raises without
    one)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    with torch.no_grad():
        return UNet(cfg, device=device, generator=generator)


def unet_loss_fn(model: UNet, batch, rng=None) -> torch.Tensor:
    """The noise-prediction loss of ``bench.py:bench_unet``, for
    :func:`..parallel.api.build_train_step`: ``batch = (x, t, eps)``,
    ``mean((model(x, t) - eps) ** 2)`` in float32."""
    x, t, eps = batch
    return torch.mean((model(x, t).float() - eps.float()) ** 2)
