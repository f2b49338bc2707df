"""Fused GroupNorm(+modulation)(+SiLU), forward and backward (the port of
``paddle_ray_tpu/ops/groupnorm.py``).

    y = act( GN(x; groups, weight, bias) * (1 + scale) + shift )

on channels-last ``x [N, ..., C]``: statistics per (sample, group) over
all but the leading dim, in float32 -- the mean first, then the centred
variance, ``rstd = rsqrt(var + eps)``.  ``scale``/``shift`` (``[N, C]``,
optional, together) are the SD-UNet's timestep modulation; ``act`` is
``"none"`` or ``"silu"``.  The forward saves ``mu`` and ``rstd`` (float32
``[N, G]``); the backward recomputes x-hat from them and gives ``dx``,
``dweight``/``dbias`` (summed over N) and ``dscale``/``dshift`` per (n,
c), all float32 but ``dx``.

:func:`fused_group_norm_fwd` and :func:`fused_group_norm_bwd` work on the
folded layout ``[N, rows, C]``.  For CUDA tensors they launch the
hand-written kernels of ``csrc/groupnorm.cu`` and count the launch in
their ``launches``; for CPU tensors they run the plain versions
(:func:`fused_group_norm_fwd_plain`, :func:`fused_group_norm_bwd_plain`).
There is no fallback between the two: a CUDA tensor the kernels do not
take raises.  :func:`fused_group_norm` is the differentiable entry with
the JAX signature.

:func:`group_norm_plan` picks the kernels' route and tiling from the
shape alone: the cluster route (a thread-block cluster holds a (sample,
group-set) slice in shared memory, read from device memory once) where
the channels are 16-byte aligned and the slice fits, else the rowwise
route (one block per (sample, group)).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

__all__ = ["fused_group_norm", "fused_group_norm_fwd", "fused_group_norm_bwd",
           "fused_group_norm_fwd_plain", "fused_group_norm_bwd_plain",
           "GroupNormPlan", "group_norm_plan"]

_ACTS = {"none": 0, "silu": 1}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _per_channel(stat: torch.Tensor, cpg: int) -> torch.Tensor:
    """``[N, G]`` -> ``[N, 1, C]``: each group's value for its channels."""
    return stat.repeat_interleave(cpg, dim=1)[:, None, :]


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the yardstick of the kernels
# ---------------------------------------------------------------------------
def fused_group_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor,
                               scale: Optional[torch.Tensor],
                               shift: Optional[torch.Tensor], *, groups: int,
                               epsilon: float, act: str
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch forward on ``x [N, rows, C]``: ``(y in x's dtype, mu,
    rstd)``, the statistics float32 ``[N, G]``."""
    n, rows, c = x.shape
    cpg = c // groups
    cnt = rows * cpg
    xf = x.float()
    xg = xf.reshape(n, rows, groups, cpg)
    mu = xg.sum(dim=(1, 3)) / cnt
    xc = xg - mu[:, None, :, None]
    var = (xc * xc).sum(dim=(1, 3)) / cnt
    rstd = torch.rsqrt(var + epsilon)
    a_mul = _per_channel(rstd, cpg) * weight.float()
    a_add = bias.float() - _per_channel(mu, cpg) * a_mul
    if scale is not None:
        mod_s = 1.0 + scale.float()[:, None, :]
        a_add = a_add * mod_s + shift.float()[:, None, :]
        a_mul = a_mul * mod_s
    w = xf * a_mul + a_add
    if act == "silu":
        w = w * torch.sigmoid(w)
    return w.to(x.dtype), mu, rstd


def fused_group_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor,
                               scale: Optional[torch.Tensor],
                               shift: Optional[torch.Tensor],
                               mu: torch.Tensor, rstd: torch.Tensor,
                               dy: torch.Tensor, *, groups: int, act: str):
    """Plain PyTorch backward, term for term the JAX ``_bwd_kernel``:
    ``(dx in x's dtype, dweight [C], dbias [C], dscale [N, C], dshift [N,
    C])``, all but ``dx`` float32; ``dscale``/``dshift`` are None without
    modulation."""
    n, rows, c = x.shape
    cpg = c // groups
    cnt = rows * cpg
    mu_c, rs_c = _per_channel(mu, cpg), _per_channel(rstd, cpg)
    gamma, beta = weight.float(), bias.float()
    xhat = (x.float() - mu_c) * rs_c
    z = xhat * gamma + beta
    dyf = dy.float()
    if scale is not None:
        mod_s = 1.0 + scale.float()[:, None, :]
        w = z * mod_s + shift.float()[:, None, :]
    else:
        w = z
    if act == "silu":
        sg = torch.sigmoid(w)
        dw = dyf * sg * (1.0 + w * (1.0 - sg))
    else:
        dw = dyf
    if scale is not None:
        ds, dt = (dw * z).sum(1), dw.sum(1)
        dz = dw * mod_s
    else:
        ds = dt = None
        dz = dw
    dz_c = dz.sum(1)                                    # [N, C]
    dzx_c = (dz * xhat).sum(1)
    m1 = (dz_c * gamma).reshape(n, groups, cpg).sum(-1) / cnt
    m2 = (dzx_c * gamma).reshape(n, groups, cpg).sum(-1) / cnt
    dx = rs_c * (dz * gamma - _per_channel(m1, cpg) - xhat
                 * _per_channel(m2, cpg))
    return dx.to(x.dtype), dzx_c.sum(0), dz_c.sum(0), ds, dt


# ---------------------------------------------------------------------------
# The kernels' plan, from the shape alone
# ---------------------------------------------------------------------------
# The H100 the plan is cut for: a block's most shared memory; the most two
# blocks of one SM can each take ((228 KB - 2 x 1 KB reserved) / 2)
GN_SMEM_BLOCK = 232_448
GN_SMEM_PAIR = 115_712
# the largest cluster (non-portable above 8) and a block's most threads
# (``kClusterMax``, ``kClusterThreads`` in ``csrc/groupnorm.cu``)
GN_CLUSTER_MAX = 16
GN_THREADS = 256
# the fewest blocks a launch keeps when group-sets widen: about two an SM
GN_WAVE_BLOCKS = 256


class GroupNormPlan(NamedTuple):
    """How :func:`fused_group_norm_fwd` / ``_bwd`` launch.  ``route`` is
    ``"cluster"`` or ``"rowwise"``; the other fields describe the cluster
    route: ``groups_per_set`` whole groups a group-set (a multiple of 16
    bytes wide), ``cluster`` blocks a (sample, group-set) slice, each of
    ``rows_per_block`` rows, ``lanes`` row lanes of one 16-byte vector a
    thread, ``threads`` a block, ``smem_bytes`` of dynamic shared memory
    a block.  ``reason`` says why a shape takes the rowwise route."""
    route: str
    groups_per_set: int = 0
    cluster: int = 0
    rows_per_block: int = 0
    lanes: int = 0
    threads: int = 0
    smem_bytes: int = 0
    reason: str = ""


def _cluster_smem(rows_b: int, lanes: int, width: int, gpset: int,
                  itemsize: int, bwd: bool) -> int:
    """``csrc/groupnorm.cu:cluster_smem_bytes``: the resident tiles (x;
    and dy in the backward), the row lanes' per-channel sums, the
    group-set's parameters, and the reduction and exchange buffers.  The
    C entries refuse a plan whose ``smem_bytes`` is not theirs."""
    gp4 = (gpset + 3) // 4 * 4
    tiles = (2 if bwd else 1) * rows_b * width * itemsize
    floats = (lanes * width + 4 * width + GN_THREADS
              + (4 * width + 2 * gp4 if bwd else 4 * gp4))
    return tiles + 4 * floats


def _fewest_groups(groups: int, cpg: int, itemsize: int,
                   align: int) -> Optional[int]:
    """The fewest whole groups whose width is a multiple of ``align``
    bytes and at most a block's threads of 16-byte vectors, or None."""
    return next((d for d in range(1, groups + 1) if groups % d == 0
                 and d * cpg * itemsize % align == 0
                 and d * cpg * itemsize // 16 <= GN_THREADS), None)


def _cluster_plan(rows: int, cpg: int, itemsize: int, bwd: bool,
                  gpset: int, k: int) -> GroupNormPlan:
    """The cluster route at ``gpset`` groups a set and (at most) ``k``
    blocks a cluster: rows a block, no block without rows, as many row
    lanes as a block's threads allow, and its shared memory."""
    rows_b = -(-rows // k)
    vectors = gpset * cpg * itemsize // 16
    lanes = min(GN_THREADS // vectors, rows_b)
    return GroupNormPlan(
        "cluster", gpset, -(-rows // rows_b), rows_b, lanes,
        (vectors * lanes + 31) // 32 * 32,
        _cluster_smem(rows_b, lanes, gpset * cpg, gpset, itemsize, bwd))


def group_norm_plan(n: int, rows: int, c: int, groups: int,
                    dtype: torch.dtype, kind: str = "fwd") -> GroupNormPlan:
    """The route and tiling of one call on ``[n, rows, c]`` of ``dtype``
    (``kind`` ``"fwd"`` or ``"bwd"``), from the shape alone.

    The cluster route takes a group-set of the fewest whole groups whose
    width is a multiple of 16 bytes; the forward first tries 32 bytes (a
    sector: each row's strips then share no sector between blocks) and
    keeps it where its slice fits two blocks an SM within 16 blocks a
    cluster (the backward, with twice the bytes a slice, ran slower so:
    larger clusters, fewer of them resident).  One thread takes a 16-byte
    vector of the group-set and ``256 // vectors`` row lanes.  A
    slice that one block holds within ``GN_SMEM_PAIR`` (two blocks an SM)
    takes one block a cluster, and its group-set doubles while that still
    holds, the block keeps a thread a group (the kernels write the
    statistics one group a thread) and the launch keeps
    ``GN_WAVE_BLOCKS`` blocks.  A larger slice
    takes the smallest cluster whose blocks fit ``GN_SMEM_PAIR``; failing
    that, 16 blocks of up to ``GN_SMEM_BLOCK``.  The rowwise route takes C
    whose rows are not a multiple of 16 bytes, group-sets wider than 256
    vectors and slices past 16 blocks' shared memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    bwd = kind == "bwd"
    if c * itemsize % 16:
        return GroupNormPlan("rowwise", reason="C * itemsize is not a "
                             "multiple of 16 bytes")
    cpg = c // groups

    def plan(g: int, k: int) -> GroupNormPlan:
        return _cluster_plan(rows, cpg, itemsize, bwd, g, k)

    candidates = [g for g in dict.fromkeys(
        ((_fewest_groups(groups, cpg, itemsize, 32),) if not bwd else ())
        + (_fewest_groups(groups, cpg, itemsize, 16),)) if g is not None]
    if not candidates:
        return GroupNormPlan("rowwise", reason="a group-set wider than a "
                             "block's threads")
    for g in candidates:
        k = next((k for k in range(1, GN_CLUSTER_MAX + 1)
                  if plan(g, k).smem_bytes <= GN_SMEM_PAIR), None)
        if k is not None:
            break
    else:
        g, k = candidates[-1], GN_CLUSTER_MAX
        if plan(g, k).smem_bytes > GN_SMEM_BLOCK:
            return GroupNormPlan("rowwise", reason="the slice is past a "
                                 "cluster's shared memory")
    if k == 1:
        while groups % (2 * g) == 0 and n * groups // (2 * g) >= \
                GN_WAVE_BLOCKS:
            wider = plan(2 * g, 1)
            if (2 * g * cpg * itemsize // 16 > GN_THREADS
                    or 2 * g > wider.threads
                    or wider.smem_bytes > GN_SMEM_PAIR):
                break
            g *= 2
    return plan(g, k)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_args(x, weight, bias, scale, shift, groups, act) -> None:
    if x.dim() != 3:
        raise ValueError(f"want x [N, rows, C], got {tuple(x.shape)}")
    n, _, c = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be [{c}], got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if scale is not None and (scale.shape != (n, c) or shift.shape != (n, c)):
        raise ValueError(f"scale and shift must be [{n}, {c}], got "
                         f"{tuple(scale.shape)}, {tuple(shift.shape)}")


def _check_cuda(x, weight, bias, scale, shift, *rest) -> None:
    """Raise on anything the CUDA kernels do not take.  ``rest`` are the
    backward's ``mu``, ``rstd`` (float32 ``[N, G]``) and ``dy`` (x's
    shape and dtype)."""
    pairs = [("weight and bias", weight, bias)]
    if scale is not None:
        pairs.append(("scale and shift", scale, shift))
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    for what, a, b in pairs:
        if a.dtype != b.dtype or a.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"kernel takes {what} of one type, float32 or "
                            f"bfloat16; got {a.dtype}, {b.dtype}")
    tensors = [("x", x), ("weight", weight), ("bias", bias)]
    if scale is not None:
        tensors += [("scale", scale), ("shift", shift)]
    if rest:
        mu, rstd, dy = rest
        for name, t in (("mu", mu), ("rstd", rstd)):
            if t.dtype != torch.float32 or t.shape != mu.shape:
                raise ValueError(f"{name} must be float32 [N, G], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} must match x")
        tensors += [("mu", mu), ("rstd", rstd), ("dy", dy)]
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("groupnorm")
    if lib.prt_group_norm_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prt_group_norm_fwd.argtypes = ([p] * 8 + [i] * 4
                                           + [ctypes.c_float] + [i] * 10 + [p])
        lib.prt_group_norm_bwd.argtypes = [p] * 15 + [i] * 14 + [p]
        for fn in ("fwd", "bwd"):
            getattr(lib, f"prt_group_norm_{fn}").restype = ctypes.c_int
        lib.prt_group_norm_error_string.argtypes = [ctypes.c_int]
        lib.prt_group_norm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.prt_group_norm_error_string(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _plan_args(plan: GroupNormPlan, *tensors: torch.Tensor) -> tuple:
    """The plan as the C entries take it: ``(route, groups_per_set,
    cluster, rows_per_block, lanes, smem_bytes)``; the rowwise route where
    one of ``tensors`` does not start on 16 bytes (a view into another
    tensor), as the cluster route's 16-byte copies need."""
    if plan.route == "cluster" and all(t.data_ptr() % 16 == 0
                                       for t in tensors):
        return (1, plan.groups_per_set, plan.cluster, plan.rows_per_block,
                plan.lanes, plan.smem_bytes)
    return (0,) * 6


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_group_norm for device {x.device}")
    return x.device.type


def fused_group_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, scale: Optional[torch.Tensor],
                         shift: Optional[torch.Tensor], *, groups: int,
                         epsilon: float = 1e-5, act: str = "none"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward on ``x [N, rows, C]``: ``(y, mu, rstd)``.  CUDA tensors
    launch the kernel of :func:`group_norm_plan`'s route; CPU tensors run
    :func:`fused_group_norm_fwd_plain`."""
    _check_args(x, weight, bias, scale, shift, groups, act)
    if _device_kind(x) == "cpu":
        return fused_group_norm_fwd_plain(x, weight, bias, scale, shift,
                                          groups=groups, epsilon=epsilon,
                                          act=act)
    _check_cuda(x, weight, bias, scale, shift)
    n, rows, c = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(n, groups, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    plan = group_norm_plan(n, rows, c, groups, x.dtype, "fwd")
    _launch("fused_group_norm", "prt_group_norm_fwd", x.device,
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(scale),
            _ptr(shift), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), n,
            rows, c, groups, float(epsilon), _ACTS[act],
            _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[weight.dtype],
            _KERNEL_DTYPES[scale.dtype] if scale is not None else 0,
            *_plan_args(plan, x, y))
    fused_group_norm_fwd.launches += 1
    return y, mu, rstd


def fused_group_norm_bwd(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, scale: Optional[torch.Tensor],
                         shift: Optional[torch.Tensor], mu: torch.Tensor,
                         rstd: torch.Tensor, dy: torch.Tensor, *, groups: int,
                         act: str = "none"):
    """Backward on ``x [N, rows, C]``: ``(dx, dweight, dbias, dscale,
    dshift)`` as :func:`fused_group_norm_bwd_plain` gives them.  CUDA
    tensors launch the kernel of :func:`group_norm_plan`'s route and the
    fixed-order reduction of dweight / dbias over N (two launches); CPU
    tensors run the plain version."""
    _check_args(x, weight, bias, scale, shift, groups, act)
    if _device_kind(x) == "cpu":
        return fused_group_norm_bwd_plain(x, weight, bias, scale, shift, mu,
                                          rstd, dy, groups=groups, act=act)
    _check_cuda(x, weight, bias, scale, shift, mu, rstd, dy)
    n, rows, c = x.shape
    if mu.shape != (n, groups):
        raise ValueError(f"mu must be [{n}, {groups}], got {tuple(mu.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    parts = torch.empty(2, n, c, **f32)
    dw_db = torch.empty(2, c, **f32)
    ds_dt = torch.empty(2, n, c, **f32) if scale is not None else None
    plan = group_norm_plan(n, rows, c, groups, x.dtype, "bwd")
    _launch("fused_group_norm_bwd", "prt_group_norm_bwd", x.device,
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(scale),
            _ptr(shift), mu.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
            None if ds_dt is None else ds_dt[0].data_ptr(),
            None if ds_dt is None else ds_dt[1].data_ptr(),
            dw_db[0].data_ptr(), dw_db[1].data_ptr(), n, rows, c, groups,
            _ACTS[act], _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[weight.dtype],
            _KERNEL_DTYPES[scale.dtype] if scale is not None else 0,
            *_plan_args(plan, x, dy, dx))
    fused_group_norm_bwd.launches += 1
    ds, dt = (None, None) if ds_dt is None else (ds_dt[0], ds_dt[1])
    return dx, dw_db[0], dw_db[1], ds, dt


fused_group_norm_fwd.launches = 0
fused_group_norm_bwd.launches = 0


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a contiguous copy counted in
    ``fused_group_norm.copies`` (a hidden copy a call on the main path)."""
    if t.is_contiguous():
        return t
    fused_group_norm.copies += 1
    return t.contiguous()


class _FusedGroupNorm(torch.autograd.Function):
    """Folded-layout fused GroupNorm whose backward is the backward kernel;
    saves ``(x, weight, bias, scale, shift, mu, rstd)``, the JAX custom
    VJP's residuals.  Gradients are cast as ``_fgn_bwd`` casts them:
    dweight/dbias to the weight's dtype, dscale/dshift to scale's."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, groups: int,
                epsilon: float, act: str):
        y, mu, rstd = fused_group_norm_fwd(x, weight, bias, scale, shift,
                                           groups=groups, epsilon=epsilon,
                                           act=act)
        ctx.save_for_backward(x, weight, bias, scale, shift, mu, rstd)
        ctx.groups, ctx.act = groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, scale, shift, mu, rstd = ctx.saved_tensors
        dx, dw, db, ds, dt = fused_group_norm_bwd(
            x, weight, bias, scale, shift, mu, rstd, _contiguous(dy),
            groups=ctx.groups, act=ctx.act)
        return (dx, dw.to(weight.dtype), db.to(bias.dtype),
                None if scale is None else ds.to(scale.dtype),
                None if shift is None else dt.to(shift.dtype),
                None, None, None)


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, groups: int,
                     epsilon: float = 1e-5,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     act: str = "none") -> torch.Tensor:
    """``y = act(GN(x; groups, weight, bias) * (1 + scale) + shift)``,
    differentiable in every tensor argument.

    x: ``[N, ..., C]`` channels-last; weight/bias: ``[C]``; scale/shift
    (optional, together): ``[N, C]`` per-sample channel modulation; act:
    ``"none"`` | ``"silu"``.  A non-contiguous x (or incoming gradient) is
    copied and the copy counted in ``fused_group_norm.copies``.  Arguments
    are checked as the JAX function checks them (``ValueError``)."""
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    orig = x.shape
    c = orig[-1]
    rows = 1
    for d in orig[1:-1]:
        rows *= d
    x2 = _contiguous(x).reshape(orig[0], rows, c)
    s2 = None if scale is None else scale.reshape(orig[0], c).contiguous()
    t2 = None if shift is None else shift.reshape(orig[0], c).contiguous()
    y = _FusedGroupNorm.apply(x2, weight, bias, s2, t2, groups, epsilon, act)
    return y.reshape(orig)


fused_group_norm.copies = 0
