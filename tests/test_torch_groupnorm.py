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
