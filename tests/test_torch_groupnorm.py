"""The port's fused GroupNorm against the JAX package's Pallas kernels.

The same numpy inputs go through ``paddle_ray_tpu.ops.groupnorm`` (its
Pallas kernels in interpret mode on the CPU, as the JAX package's own
tests run them) and through the port's plain versions (CPU tensors):
the forward's ``y``, ``mu`` and ``rstd``, the backward's ``dx``,
``dweight``, ``dbias``, ``dscale`` and ``dshift`` from the same saved
statistics, and the differentiable ``fused_group_norm`` against the JAX
custom VJP.  Cases: act none/silu, with and without the scale/shift
modulation, 4 and 2 channels a group (10 in the 40-channel cases), odd
row counts, float32 and bfloat16.

Tolerances, as ``max|err| / max|ref|``: float32 1e-5 (the sums run in
another order); bfloat16 outputs (``y``, ``dx``) 2e-2, one bfloat16
rounding of an output near a rounding boundary; the float32 sums the
bfloat16 cases give (statistics, ``dweight``, ...) 1e-5 as in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.ops import groupnorm as jax_gn
from paddle_ray_tpu_torch.ops import groupnorm as gn
from paddle_ray_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                fused_group_norm_bwd,
                                                fused_group_norm_fwd)

EPS = 1e-5
# name: (shape [N, ..., C], groups, modulation, act, dtype)
CASES = {
    "c40_g4_none_f32": ((2, 8, 8, 40), 4, False, "none", "float32"),
    "c40_g4_silu_f32": ((2, 8, 8, 40), 4, False, "silu", "float32"),
    "c40_g4_mod_silu_f32": ((2, 8, 8, 40), 4, True, "silu", "float32"),
    "odd_rows_mod_none_f32": ((3, 7, 9, 40), 4, True, "none", "float32"),
    "c64_g32_mod_silu_f32": ((2, 4, 4, 64), 32, True, "silu", "float32"),
    "c40_g4_mod_silu_bf16": ((2, 8, 8, 40), 4, True, "silu", "bfloat16"),
    "odd_rows_g8_silu_bf16": ((2, 7, 7, 40), 8, False, "silu", "bfloat16"),
}
F32_TOL = 1e-5
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, mod, dtype, seed=0):
    """Numpy inputs (the mean offset makes the centred variance matter)
    and the same values as JAX arrays and torch tensors in ``dtype``."""
    r = np.random.RandomState(seed)
    n, c = shape[0], shape[-1]
    a = {"x": 1.5 * r.randn(*shape) + 0.7,
         "w": 1.0 + 0.2 * r.randn(c), "b": 0.2 * r.randn(c),
         "dy": r.randn(*shape)}
    if mod:
        a["s"], a["t"] = 0.3 * r.randn(n, c), 0.3 * r.randn(n, c)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = {k: jnp.asarray(v, jdt) for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(tdt) for k, v in a.items()}
    return j, t


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     np.asarray(got, np.float32), np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _fold(a, shape):
    return a.reshape(shape[0], -1, shape[-1])


@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernels' outputs for every case, computed once."""
    out = {}
    for name, (shape, groups, mod, act, dtype) in CASES.items():
        j, _ = _inputs(shape, mod, dtype)
        x2, dy2 = _fold(j["x"], shape), _fold(j["dy"], shape)
        s, t = j.get("s"), j.get("t")
        y, mu, rs = jax_gn._fwd_call(x2, j["w"], j["b"], s, t, groups, EPS,
                                     act, True)
        bwd = jax_gn._bwd_call(x2, j["w"], j["b"], s, t, mu, rs, dy2, groups,
                               EPS, act, True)

        def f(x, w, b, s, t):
            return jax_gn.fused_group_norm(x, w, b, groups=groups,
                                           epsilon=EPS, scale=s, shift=t,
                                           act=act)
        y_pub, vjp = jax.vjp(f, j["x"], j["w"], j["b"], s, t)
        cot = vjp(j["dy"])
        out[name] = {"y": _np(y), "mu": _np(mu), "rstd": _np(rs),
                     "bwd": [None if a is None else _np(a) for a in bwd],
                     "y_pub": _np(y_pub),
                     "cot": [None if a is None else _np(a) for a in cot],
                     "cot_dtypes": [None if a is None else str(a.dtype)
                                    for a in cot]}
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_jax(name, jax_results):
    shape, groups, mod, act, dtype = CASES[name]
    want = jax_results[name]
    _, t = _inputs(shape, mod, dtype)
    y, mu, rstd = fused_group_norm_fwd(
        _fold(t["x"], shape), t["w"], t["b"], t.get("s"), t.get("t"),
        groups=groups, epsilon=EPS, act=act)
    assert y.dtype == t["x"].dtype and y.shape == _fold(t["x"], shape).shape
    assert mu.dtype == rstd.dtype == torch.float32
    assert mu.shape == rstd.shape == (shape[0], groups)
    assert _rel(mu, want["mu"]) <= F32_TOL
    assert _rel(rstd, want["rstd"]) <= F32_TOL
    assert _rel(y, want["y"]) <= OUT_TOL[dtype]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax(name, jax_results):
    """dx, dweight, dbias (float32 sums over N), dscale, dshift (float32
    per (n, c)) from the JAX forward's saved statistics."""
    shape, groups, mod, act, dtype = CASES[name]
    want = jax_results[name]
    _, t = _inputs(shape, mod, dtype)
    got = fused_group_norm_bwd(
        _fold(t["x"], shape), t["w"], t["b"], t.get("s"), t.get("t"),
        torch.tensor(want["mu"]), torch.tensor(want["rstd"]),
        _fold(t["dy"], shape), groups=groups, act=act)
    dx, dw, db, ds, dt = got
    assert dx.dtype == t["x"].dtype
    assert dw.dtype == db.dtype == torch.float32
    assert _rel(dx, want["bwd"][0]) <= OUT_TOL[dtype]
    for label, g, w in zip(("dweight", "dbias", "dscale", "dshift"),
                           got[1:], want["bwd"][1:]):
        if w is None:
            assert g is None, label
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape, label
        assert _rel(g, w) <= F32_TOL, label


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_matches_jax_vjp(name, jax_results):
    """``fused_group_norm`` on CPU tensors of ``[N, H, W, C]``: ``y`` and
    every gradient, cast as the JAX custom VJP casts them."""
    shape, groups, mod, act, dtype = CASES[name]
    want = jax_results[name]
    _, t = _inputs(shape, mod, dtype)
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()
              if k != "dy"}
    y = fused_group_norm(leaves["x"], leaves["w"], leaves["b"],
                         groups=groups, epsilon=EPS, scale=leaves.get("s"),
                         shift=leaves.get("t"), act=act)
    assert y.shape == shape and y.dtype == t["x"].dtype
    assert _rel(y.detach(), want["y_pub"]) <= OUT_TOL[dtype]
    y.backward(t["dy"])
    for key, w, wdt in zip(("x", "w", "b", "s", "t"), want["cot"],
                           want["cot_dtypes"]):
        if w is None:
            assert key not in leaves
            continue
        g = leaves[key].grad
        assert str(g.dtype).replace("torch.", "") == wdt, key
        tol = OUT_TOL[dtype] if (key == "x" or dtype == "bfloat16") \
            else F32_TOL
        assert _rel(g, w) <= tol, key


def test_validation_errors_match_jax():
    j, t = _inputs((2, 4, 4, 40), True, "float32")
    bad = [dict(groups=4, scale="s"),                # scale without shift
           dict(groups=4, act="gelu"),               # unknown act
           dict(groups=6)]                           # 40 % 6 != 0
    for kw in bad:
        for side, fn in (("jax", jax_gn.fused_group_norm),
                         ("port", fused_group_norm)):
            arrs = j if side == "jax" else t
            kw_ = dict(kw)
            if "scale" in kw_:
                kw_["scale"] = arrs["s"]
            with pytest.raises(ValueError):
                fn(arrs["x"], arrs["w"], arrs["b"], **kw_)


def test_kernel_argument_checks():
    """What the CUDA kernels do not take raises before any launch: float16
    x, mixed weight/bias types, a non-contiguous x; a device other than
    the CPU or CUDA has no path."""
    _, t = _inputs((2, 4, 4, 40), True, "float32")
    x2 = _fold(t["x"], (2, 4, 4, 40))
    args = (t["w"], t["b"], t["s"], t["t"])
    with pytest.raises(TypeError):
        gn._check_cuda(x2.half(), *args)
    with pytest.raises(TypeError):
        gn._check_cuda(x2, t["w"], t["b"].bfloat16(), t["s"], t["t"])
    with pytest.raises(ValueError, match="contiguous"):
        gn._check_cuda(x2.transpose(0, 1).contiguous().transpose(0, 1),
                       *args)
    with pytest.raises(ValueError, match="device"):
        fused_group_norm_fwd(x2.to("meta"), *(a.to("meta") for a in args),
                             groups=4)


def test_non_contiguous_input_is_copied_and_counted():
    _, t = _inputs((2, 4, 4, 40), False, "float32")
    xt = t["x"].transpose(1, 2).contiguous().transpose(1, 2)
    assert not xt.is_contiguous()
    before = fused_group_norm.copies
    got = fused_group_norm(xt, t["w"], t["b"], groups=4, act="silu")
    want = fused_group_norm(t["x"], t["w"], t["b"], groups=4, act="silu")
    assert fused_group_norm.copies == before + 1
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The kernels' plan (pure Python; the kernels index their tiles as
# ``_plan_blocks`` and the thread tiling below say)
# ---------------------------------------------------------------------------
# (N, rows, C, groups, dtype, route): the SD-UNet training step's 14 (rows, C)
# shapes at batch 32 in bfloat16, then the chip smoke's other cases
PLAN_CASES = {
    **{f"unet_{rows}x{c}": (32, rows, c, 32, torch.bfloat16, "cluster")
       for rows, c in ((4096, 320), (4096, 640), (4096, 960), (1024, 320),
                       (1024, 640), (1024, 960), (1024, 1280), (1024, 1920),
                       (256, 640), (256, 1280), (256, 1920), (256, 2560),
                       (64, 1280), (64, 2560))},
    "f32_4096x320": (32, 4096, 320, 32, torch.float32, "cluster"),
    "f32_256x1280": (32, 256, 1280, 32, torch.float32, "cluster"),
    "f32_64x2560": (32, 64, 2560, 32, torch.float32, "cluster"),
    "odd_rows_63x640_g16": (32, 63, 640, 16, torch.bfloat16, "cluster"),
    "g2_cpg320_f32": (8, 1024, 640, 2, torch.float32, "cluster"),
    "g4_cpg10_4095x40": (4, 4095, 40, 4, torch.bfloat16, "cluster"),
    "cpg2_c64_g32": (2, 100, 64, 32, torch.bfloat16, "cluster"),
    "n512_1x256_g64_cpg4": (512, 1, 256, 64, torch.bfloat16, "cluster"),
    "n1024_4x512_g512_cpg1_f32": (1024, 4, 512, 512, torch.float32,
                                  "cluster"),
    "n4096_1x2048_g2048_cpg1": (4096, 1, 2048, 2048, torch.bfloat16,
                                "cluster"),
    "unaligned_c36_g4": (2, 4096, 36, 4, torch.bfloat16, "rowwise"),
    "unaligned_c44_g4_odd": (2, 49, 44, 4, torch.bfloat16, "rowwise"),
    "past_cluster_65536x320": (2, 65536, 320, 32, torch.bfloat16,
                               "rowwise"),
    "past_cluster_f32_bwd_only": (1, 2048, 640, 2, torch.float32, None),
}


def _plan_blocks(plan, n, rows, c, groups):
    """The tiles of a cluster-route launch as the kernels index them
    (``csrc/groupnorm.cu``: block x is rank x % cluster of the cluster x /
    cluster, whose slice is sample cl / group-sets, group-set cl %
    group-sets): ``(sample, rows range, channels range)`` a block, in
    launch order."""
    width = plan.groups_per_set * (c // groups)
    for s in range(n):
        for gs in range(groups // plan.groups_per_set):
            for rank in range(plan.cluster):
                r0 = rank * plan.rows_per_block
                yield (s, range(r0, min(rows, r0 + plan.rows_per_block)),
                       range(gs * width, (gs + 1) * width))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_group_norm_plan(name, kind):
    """Every (n, row, channel) in exactly one block's tile and one thread's
    16-byte vector; every group whole in one group-set; a thread of the
    block for each group of its set; a block's shared memory within the
    card's 232,448 bytes; every copy 16-byte aligned;
    the unaligned C and the slices past a cluster's shared memory on the
    rowwise route."""
    n, rows, c, groups, dtype, route = PLAN_CASES[name]
    plan = gn.group_norm_plan(n, rows, c, groups, dtype, kind)
    if route is None:       # a slice that fits forward but not backward
        route = "cluster" if kind == "fwd" else "rowwise"
    assert plan.route == route, plan
    itemsize = torch.empty((), dtype=dtype).element_size()
    if route == "rowwise":
        assert plan.reason
        return
    cpg = c // groups
    width = plan.groups_per_set * cpg
    vec = 16 // itemsize
    assert groups % plan.groups_per_set == 0
    assert (c * itemsize) % 16 == 0 and (width * itemsize) % 16 == 0
    assert 1 <= plan.cluster <= gn.GN_CLUSTER_MAX
    assert plan.smem_bytes <= gn.GN_SMEM_BLOCK
    assert plan.smem_bytes == gn._cluster_smem(
        plan.rows_per_block, plan.lanes, width, plan.groups_per_set,
        itemsize, kind == "bwd")
    vectors = width // vec
    assert vectors * plan.lanes <= plan.threads <= gn.GN_THREADS
    assert plan.threads % 32 == 0
    # a thread a group: the kernels write each group's statistics from its
    # own thread
    assert plan.groups_per_set <= plan.threads
    # the blocks' tiles, sample by sample
    seen = np.zeros((rows, c), np.int32)
    sample, blocks = 0, 0
    for s, rr, cc in _plan_blocks(plan, n, rows, c, groups):
        if s != sample:
            assert (seen == 1).all() and s == sample + 1
            seen[:] = 0
            sample = s
        assert len(rr) > 0, "a block without rows"
        assert cc.start % cpg == 0 and len(cc) == width   # whole groups
        assert len(rr) <= plan.rows_per_block
        seen[rr.start:rr.stop, cc.start:cc.stop] += 1
        blocks += 1
    assert (seen == 1).all() and sample == n - 1
    assert blocks == n * (groups // plan.groups_per_set) * plan.cluster
    # one block's rows over its threads: thread (v, l) owns vector v of rows
    # l, l + lanes, ... (``owner_of`` in csrc/groupnorm.cu)
    for nrows in {plan.rows_per_block,
                  rows - (plan.cluster - 1) * plan.rows_per_block}:
        own = np.zeros((nrows, vectors), np.int32)
        for tid in range(vectors * plan.lanes):
            v, lane = tid % vectors, tid // vectors
            own[lane:nrows:plan.lanes, v] += 1
        assert (own == 1).all()
    # every 16-byte copy starts on 16 bytes: (row * C + group-set start + v *
    # vec) elements
    starts = (np.arange(groups // plan.groups_per_set)[:, None] * width
              + np.arange(vectors)[None, :] * vec) * itemsize
    assert (starts % 16 == 0).all() and (c * itemsize) % 16 == 0


def test_group_norm_plan_routes_by_alignment():
    """A tensor that does not start on 16 bytes takes the rowwise route;
    the plan's cluster route otherwise."""
    plan = gn.group_norm_plan(2, 64, 640, 32, torch.bfloat16, "fwd")
    x = torch.zeros(2 * 64 * 640 + 1, dtype=torch.bfloat16)
    assert gn._plan_args(plan, x[:-1])[0] == 1
    assert gn._plan_args(plan, x[1:])[0] == 0
    assert gn._plan_args(
        gn.group_norm_plan(2, 64, 36, 4, torch.bfloat16, "fwd"), x)[0] == 0
