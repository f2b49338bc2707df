"""The port's eight other optimizers (SGD, Momentum, Lamb, Adamax,
Adadelta, Adagrad, RMSProp, LARS) against the JAX package's, fed the same
gradients on the CPU.

Each runs 3 steps over a few float32 tensors (matrices decay, vectors do
not), without and with weight decay, and over bfloat16 parameters with
float32 masters.  Tolerances: float32 parameters, slots and masters within
``rtol`` 1e-6 (``atol`` 1e-9 for values near 0): the arithmetic is the
JAX order's, one float32 operation at a time, but PyTorch's CPU ``sqrt``
may be an ulp off the correctly rounded one XLA gives; Lamb's and LARS's
norms sum in another order, which the same bound covers at these sizes.
The bfloat16 parameters are their masters rounded, each within one
bfloat16 step of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu_torch import optimizer as optim
from paddle_ray_tpu_torch.weights import optimizer_from_jax_state

SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 6), "d": (40,)}

# each optimizer's keyword arguments, the same on both sides
OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "Momentum_nesterov": dict(learning_rate=0.05, momentum=0.8,
                              use_nesterov=True),
    "Lamb": dict(learning_rate=0.01, beta1=0.8, beta2=0.95),
    "Adamax": dict(learning_rate=0.01, beta1=0.85),
    "Adadelta": dict(learning_rate=1.0, rho=0.9, epsilon=1e-5),
    "Adagrad": dict(learning_rate=0.05),
    "RMSProp": dict(learning_rate=0.01, rho=0.9),
    "LARS": dict(learning_rate=0.5, momentum=0.9, lars_coeff=0.01),
}


def _cls(name):
    return name.split("_")[0]


def _params(seed):
    r = np.random.RandomState(seed)
    return {k: (0.5 * r.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed, step):
    r = np.random.RandomState(100 * seed + step)
    return {k: (r.randn(*s) * 10.0 ** r.uniform(-3, 0)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_run(name, kw, params, dtype, steps, seed):
    opt = getattr(jax_optim, _cls(name))(**kw)
    p = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    state = opt.init(p)
    for step in range(steps):
        g = {k: jnp.asarray(v).astype(dtype)
             for k, v in _grads(seed, step).items()}
        p, state = opt.step(g, p, state)
    return p, state


def _port(name, kw, params, dtype):
    tp = {k: torch.nn.Parameter(torch.tensor(v).to(dtype))
          for k, v in params.items()}
    opt = getattr(optim, _cls(name))(**kw)
    opt.bind(list(tp.items()))
    return tp, opt


def _port_steps(tp, opt, seed, steps, first=0):
    for step in range(first, first + steps):
        for k, g in _grads(seed, step).items():
            tp[k].grad = torch.from_numpy(g).to(tp[k].dtype)
        opt.step()


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-9, err_msg=what)


def _check(tp, opt, p, state, dtype):
    assert opt.step_count == int(state.step)
    for k, t in tp.items():
        st = opt.state[t]
        assert set(opt.slot_names) == set(state.slots)
        for slot in opt.slot_names:
            _close(st[slot], state.slots[slot][k], f"{slot} of {k}")
        if dtype == torch.bfloat16:
            _close(st["master"], state.master[k], f"master of {k}")
            want = np.asarray(p[k].astype(jnp.float32))
            step = np.abs(want) * 2.0 ** -7 + 1e-30
            assert (np.abs(t.detach().float().numpy() - want)
                    <= step).all(), k
        else:
            assert "master" not in st
            _close(t, p[k], k)


@pytest.mark.parametrize("variant", ["plain", "decay", "bf16_master"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_fed_gradients_match_jax(name, variant):
    kw = dict(OPTIMIZERS[name])
    if variant == "decay":
        kw["weight_decay"] = 0.01
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if variant == "bf16_master"
                else (jnp.float32, torch.float32))
    params = _params(1)
    p, state = _jax_run(name, kw, params, jdt, 3, 1)
    tp, opt = _port(name, kw, params, tdt)
    _port_steps(tp, opt, 1, 3)
    _check(tp, opt, p, state, tdt)


def test_trust_ratios_stay_on_the_device():
    """Lamb's and LARS's per-parameter norms select the trust ratio with
    ``torch.where``: a zero parameter (norm 0) takes ratio 1, as in JAX."""
    params = _params(2)
    params["b"][:] = 0.0
    for name in ("Lamb", "LARS"):
        kw = OPTIMIZERS[name]
        p, state = _jax_run(name, kw, params, jnp.float32, 2, 2)
        tp, opt = _port(name, kw, params, torch.float32)
        _port_steps(tp, opt, 2, 2)
        _check(tp, opt, p, state, torch.float32)


def test_adadelta_ignores_the_learning_rate():
    params = _params(3)
    runs = []
    for lr in (1.0, 123.0):
        tp, opt = _port("Adadelta", dict(learning_rate=lr), params,
                        torch.float32)
        _port_steps(tp, opt, 3, 2)
        runs.append({k: t.detach().clone() for k, t in tp.items()})
    for k in params:
        assert torch.equal(runs[0][k], runs[1][k])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_carries_from_jax_mid_curve(name):
    """Two JAX steps, the state carried into the port by
    ``optimizer_from_jax_state`` under the JAX slot names (and masters),
    one more step on each side."""
    kw = OPTIMIZERS[name]
    params = _params(4)
    p, state = _jax_run(name, kw, params, jnp.bfloat16, 2, 4)
    tp, opt = _port(name, kw, {k: np.asarray(v.astype(jnp.float32))
                               for k, v in p.items()}, torch.bfloat16)
    optimizer_from_jax_state(opt, int(state.step), state.slots,
                             master=state.master)
    jopt = getattr(jax_optim, _cls(name))(**kw)
    g = {k: jnp.asarray(v).astype(jnp.bfloat16)
         for k, v in _grads(4, 2).items()}
    p, state = jopt.step(g, p, state)
    _port_steps(tp, opt, 4, 1, first=2)
    _check(tp, opt, p, state, torch.bfloat16)


def test_a_parameter_without_gradient_is_left_alone():
    params = _params(5)
    tp, opt = _port("LARS", OPTIMIZERS["LARS"], params, torch.float32)
    before = tp["a"].detach().clone()
    for k, g in _grads(5, 0).items():
        if k != "a":
            tp[k].grad = torch.from_numpy(g)
    opt.step()
    assert torch.equal(tp["a"].detach(), before)
    assert torch.equal(opt.state[tp["a"]]["velocity"],
                       torch.zeros_like(before))
    assert opt.step_count == 1
