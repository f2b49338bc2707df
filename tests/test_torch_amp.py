"""The port's AMP (``auto_cast``, ``decorate``, ``GradScaler``) and the
train step's ``has_aux`` and ``scaler`` against the JAX package, on the CPU.

Tolerances: a tiny float32 GPT under ``auto_cast("bfloat16")`` (O1) and
after ``decorate`` (O2): loss within ``rtol`` 1e-4 and each gradient
within 5e-2 of its largest value (``max|err| / max|ref|``); over seeds
0-7 the largest errors seen were 1.9e-5 (loss) and 0.023 (gradient), the
gradient's as large as JAX's own bfloat16-against-float32 difference,
since XLA and PyTorch round the backward's bfloat16 sums at other places.
So the values cannot tell where the casts are: the same test holds the
dtype of every LayerNorm's and linear's input and output, in call order,
to the JAX model's.  Each cast point alone (``Linear``, ``Conv2D``,
``Conv2DTranspose``, the two TP linears, ``QATLinear``) gives JAX's
bfloat16 output within one bfloat16 rounding; the ``has_aux`` steps within
``rtol`` 1e-5 (``atol`` 1e-7): a linear layer's product sums in another
order; the scaler steps within ``rtol`` 1e-6 (float32) / 1e-3 (float16
parameters, their float32 masters rounded), the scaler state exactly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu import amp as jax_amp
from paddle_ray_tpu import nn as jnn
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.core.module import Module as JaxModule
from paddle_ray_tpu.core.module import tree_at
from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch import amp
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.nn.layers import Linear
from paddle_ray_tpu_torch.optimizer import SGD, Momentum
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          optimizer_from_jax_state,
                                          to_jax_key)

SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)


@pytest.fixture
def one_device_topology():
    saved = current_topology()
    topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    try:
        yield topo
    finally:
        set_topology(saved)


def test_policy_is_thread_local_and_restored():
    import threading
    assert not amp.current_policy().enabled
    seen = []
    with amp.auto_cast(dtype="bfloat16"):
        assert amp.current_policy().compute_dtype == torch.bfloat16
        t = threading.Thread(
            target=lambda: seen.append(amp.current_policy().enabled))
        t.start()
        t.join()
        with amp.auto_cast(level="O0"):
            assert not amp.current_policy().enabled
        assert amp.current_policy().enabled
        x = torch.ones(2, dtype=torch.float32)
        assert amp.cast_if_enabled(x).dtype == torch.bfloat16
        ids = torch.ones(2, dtype=torch.long)
        assert amp.cast_if_enabled(ids) is ids
    assert seen == [False]
    assert not amp.current_policy().enabled
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass
    assert amp.amp_guard is amp.auto_cast


def _gpt_pair(seed):
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**SHAPE))
    r = np.random.RandomState(seed)
    state = {k: (0.1 * r.randn(*np.shape(a))).astype(np.float32)
             for k, a in jm.state_dict().items()}
    jm.load_state_dict(state)
    tm = gpt_from_jax_state_dict(GPTConfig(**SHAPE), state, device="cpu")
    r = np.random.RandomState(seed + 1)
    ids = r.randint(0, SHAPE["vocab_size"], (2, 32)).astype(np.int32)
    return jm, tm, ids


# the layers whose calls the GPT test records, by class name
_CAST_SITES = ("LayerNorm", "ColumnParallelLinear", "RowParallelLinear")


def _record_jax_calls(monkeypatch, calls):
    """Record ``(class, input dtype, output dtype)`` of every JAX layer of
    ``_CAST_SITES`` called."""
    from paddle_ray_tpu.nn.layers import LayerNorm as JaxLayerNorm
    from paddle_ray_tpu.parallel import tp as jax_tp
    for cls in (JaxLayerNorm, jax_tp.ColumnParallelLinear,
                jax_tp.RowParallelLinear):
        def forward(self, x, _fwd=cls.forward, _name=cls.__name__):
            y = _fwd(self, x)
            calls.append((_name, str(x.dtype), str(y.dtype)))
            return y
        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_gpt_under_auto_cast_matches_jax(level, monkeypatch):
    jm, tm, ids = _gpt_pair(7)
    if level == "O2":
        jm = jax_amp.decorate(jm, dtype="bfloat16")
        assert amp.decorate(tm, dtype="bfloat16") is tm
        assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    jax_calls, calls = [], []
    _record_jax_calls(monkeypatch, jax_calls)
    with jax_amp.auto_cast(dtype="bfloat16", level=level):
        loss_j, grads_j = jax_value_and_grad(
            lambda m, i: m.loss(i, i))(jm, jnp.asarray(ids))
    grads_j = dict(grads_j.named_parameters())
    t = torch.tensor(ids).long()
    hooks = [m.register_forward_hook(
        lambda m, i, o: calls.append((type(m).__name__,
                                      str(i[0].dtype).split(".")[-1],
                                      str(o.dtype).split(".")[-1])))
        for m in tm.modules() if type(m).__name__ in _CAST_SITES]
    with amp.auto_cast(dtype="bfloat16", level=level):
        loss = tm.loss(t, t)
    for h in hooks:
        h.remove()
    loss.backward()
    # a block calls ln1 qkv out ln2 fc1 fc2; then the head's norm.  The
    # JAX model scans its blocks, so one block's calls are traced
    assert len(jax_calls) == 6 + 1
    assert calls == jax_calls[:6] * SHAPE["num_layers"] + jax_calls[6:]
    if level == "O1":   # float32 inputs cast at the linears
        assert ("ColumnParallelLinear", "float32", "bfloat16") in calls
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    for name, p in tm.named_parameters():
        want = np.asarray(grads_j[to_jax_key(name)], np.float32)
        got = p.grad.float().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < 5e-2, (name, err)


def _cast_site_pairs():
    from paddle_ray_tpu.parallel import tp as jax_tp
    from paddle_ray_tpu.quantization import quant as jax_quant
    from paddle_ray_tpu_torch.nn import layers
    from paddle_ray_tpu_torch.parallel import tp
    from paddle_ray_tpu_torch.quantization import quant
    lin, img = (3, 6), (2, 5, 5, 3)
    return {
        "Linear": (lambda: jnn.Linear(6, 5), lambda: Linear(6, 5), lin),
        "Conv2D": (lambda: jnn.Conv2D(3, 4, 3, padding=1),
                   lambda: layers.Conv2D(3, 4, 3, padding=1), img),
        "Conv2DTranspose": (
            lambda: jnn.Conv2DTranspose(3, 4, 2, stride=2),
            lambda: layers.Conv2DTranspose(3, 4, 2, stride=2), img),
        "ColumnParallelLinear": (
            lambda: jax_tp.ColumnParallelLinear(6, 5),
            lambda: tp.ColumnParallelLinear(6, 5), lin),
        "RowParallelLinear": (lambda: jax_tp.RowParallelLinear(6, 5),
                              lambda: tp.RowParallelLinear(6, 5), lin),
        "QATLinear": (lambda: jax_quant.QATLinear(jnn.Linear(6, 5)),
                      lambda: quant.QATLinear(Linear(6, 5)), lin),
    }


@pytest.mark.parametrize("layer", ["Linear", "Conv2D", "Conv2DTranspose",
                                   "ColumnParallelLinear",
                                   "RowParallelLinear", "QATLinear"])
def test_each_cast_point_computes_in_bfloat16_like_jax(layer):
    """A float32 layer called on a float32 input inside ``auto_cast``:
    the output is bfloat16, as JAX's, and equal to it within one bfloat16
    rounding."""
    make_jax, make_torch, shape = _cast_site_pairs()[layer]
    prt.seed(5)
    jl, tl = make_jax(), make_torch()
    tl.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                        for k, v in jl.state_dict().items()})
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    with jax_amp.auto_cast(dtype="bfloat16"):
        want = jl(jnp.asarray(x))
    with amp.auto_cast(dtype="bfloat16"):
        got = tl(torch.tensor(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(want).max())


class _JaxBuffered(JaxModule):
    def __init__(self):
        self.lin = jnn.Linear(4, 3)
        self.register_buffer("running", jnp.zeros((3,), jnp.float32))


class _Buffered(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        self.lin = Linear(4, 3)
        with torch.no_grad():
            self.lin.weight.copy_(torch.tensor(np.asarray(jm.lin.weight)))
            self.lin.bias.copy_(torch.tensor(np.asarray(jm.lin.bias)))
        self.register_buffer("running", torch.zeros(3))


def _jax_aux_loss(m, batch, rng):
    x, y = batch
    out = m.lin(x)
    loss = jnp.mean((out + m.running - y) ** 2)
    new = 0.9 * m.running + 0.1 * jax.lax.stop_gradient(jnp.mean(out, 0))
    return loss, tree_at(lambda t: t.running, m, new)


def _aux_loss(returns_copy):
    def loss_fn(m, batch, rng):
        x, y = batch
        out = m.lin(x)
        loss = ((out + m.running - y) ** 2).mean()
        new = 0.9 * m.running + 0.1 * out.detach().mean(0)
        if returns_copy:
            m = copy.deepcopy(m)
        m.running = new
        return loss, m
    return loss_fn


@pytest.mark.parametrize("returns_copy", [False, True],
                         ids=["in_place", "copy"])
@pytest.mark.parametrize("accum", [1, 2])
def test_has_aux_threads_buffers_like_jax(one_device_topology, accum,
                                          returns_copy):
    prt.seed(3)
    jm = _JaxBuffered()
    tm = _Buffered(jm)
    jts = jax_build_train_step(jm, jax_optim.SGD(0.1), _jax_aux_loss,
                               topo=one_device_topology, donate=False,
                               has_aux=True, grad_accum=accum)
    ts = build_train_step(tm, SGD(0.1), _aux_loss(returns_copy),
                          has_aux=True, grad_accum=accum)
    r = np.random.RandomState(accum)
    for _ in range(3):
        x = r.randn(4, 4).astype(np.float32)
        y = r.randn(4, 3).astype(np.float32)
        lj = jts.step((jnp.asarray(x), jnp.asarray(y)))
        lt = ts.step((torch.tensor(x), torch.tensor(y)))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(tm.running.numpy(),
                               np.asarray(jts.model.running), rtol=1e-5,
                               atol=1e-7)
    assert float(tm.running.abs().sum()) > 0
    np.testing.assert_allclose(tm.lin.weight.detach().numpy(),
                               np.asarray(jts.model.lin.weight), rtol=1e-5,
                               atol=1e-7)


def test_grad_scaler_update_rule_matches_jax():
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    js, ts = jax_amp.GradScaler(**kw), amp.GradScaler(**kw)
    sj, st = js.init_state(), ts.init_state()
    pattern = [0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0]
    for bad in pattern:
        sj = js.update(sj, jnp.asarray(bool(bad)))
        st = ts.update(st, torch.tensor(bool(bad)))
        for f in ("scale", "growth_tracker", "bad_tracker"):
            assert float(getattr(st, f)) == float(getattr(sj, f)), f
    assert float(st.scale) == 1.0 * 2 ** 1   # floor 1, then grown once
    assert st.scale.dtype == torch.float32
    assert st.growth_tracker.dtype == torch.int32


def _linear_pair(seed, dtype):
    prt.seed(seed)
    jm = jnn.Linear(4, 4, dtype=dtype)
    tm = Linear(4, 4, dtype=getattr(torch, dtype))
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(jm.weight, np.float32)))
        tm.bias.copy_(torch.tensor(np.asarray(jm.bias, np.float32)))
    return jm, tm


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_scaler_skips_an_overflow_step_like_jax(one_device_topology,
                                                dtype):
    """The JAX contract (tests/test_optimizer.py): an overflowing step
    leaves the weights, the slots and the optimizer's step count and halves
    the scale; a clean step updates and keeps it."""
    jm, tm = _linear_pair(21, dtype)
    kw = dict(init_loss_scaling=1024.0, decr_ratio=0.5,
              decr_every_n_nan_or_inf=1, incr_every_n_steps=10 ** 6)

    def jloss(m, batch, rng):
        x, y = batch
        return jnp.mean((m(x).astype(jnp.float32) - y) ** 2)

    def tloss(m, batch, rng):
        x, y = batch
        return ((m(x).float() - y) ** 2).mean()
    jts = jax_build_train_step(jm, jax_optim.Momentum(0.1), jloss,
                               topo=one_device_topology, donate=False,
                               scaler=jax_amp.GradScaler(**kw))
    ts = build_train_step(tm, Momentum(0.1), tloss,
                          scaler=amp.GradScaler(**kw))
    assert float(ts.scaler_state.scale) == 1024.0
    w0 = tm.weight.detach().clone()
    y = np.zeros((2, 4), np.float32)
    big = 1e38 if dtype == "float32" else 6e4
    x_bad = np.full((2, 4), big, np.float32)
    x = np.ones((2, 4), np.float32)
    tdt = getattr(torch, dtype)
    for xb in (x_bad, x, x_bad, x):
        jts.step((jnp.asarray(xb).astype(dtype), jnp.asarray(y)))
        ts.step((torch.tensor(xb).to(tdt), torch.tensor(y)))
        if xb is x_bad:
            assert torch.equal(tm.weight.detach(), w0)
        else:
            w0 = tm.weight.detach().clone()
        sj = jts.scaler_state
        for f in ("scale", "growth_tracker", "bad_tracker"):
            assert float(getattr(ts.scaler_state, f)) == float(
                getattr(sj, f)), f
    assert float(ts.scaler_state.scale) == 256.0
    assert ts.opt.step_count == 2 and ts.step_count == 4
    np.testing.assert_allclose(
        tm.weight.detach().float().numpy(),
        np.asarray(jts.model.weight, np.float32),
        rtol=1e-6 if dtype == "float32" else 1e-3)


def test_scaler_state_carries_from_jax(one_device_topology):
    """A JAX step's ``ScalerState`` and Momentum state, loaded by
    ``optimizer_from_jax_state`` into a port TrainState mid-curve: the
    next steps match."""
    jm, tm = _linear_pair(5, "float32")
    kw = dict(init_loss_scaling=64.0, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=2)

    def jloss(m, batch, rng):
        return jnp.mean((m(batch[0]) - batch[1]) ** 2)

    def tloss(m, batch, rng):
        return ((m(batch[0]) - batch[1]) ** 2).mean()
    jts = jax_build_train_step(jm, jax_optim.Momentum(0.05), jloss,
                               topo=one_device_topology, donate=False,
                               scaler=jax_amp.GradScaler(**kw))
    r = np.random.RandomState(0)
    batches = [(r.randn(3, 4).astype(np.float32),
                r.randn(3, 4).astype(np.float32)) for _ in range(5)]
    batches[1] = (np.full((3, 4), 1e38, np.float32), batches[1][1])
    for b in batches[:3]:
        jts.step(tuple(jnp.asarray(v) for v in b))
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.asarray(jts.model.weight)))
        tm.bias.copy_(torch.tensor(np.asarray(jts.model.bias)))
    ts = build_train_step(tm, Momentum(0.05), tloss,
                          scaler=amp.GradScaler(**kw))
    opt_state, sstate = jts.opt_state
    optimizer_from_jax_state(
        ts, int(opt_state.step),
        {"velocity": dict(opt_state.slots["velocity"].named_parameters())},
        scaler_state=sstate)
    assert float(ts.scaler_state.growth_tracker) == 1.0
    for b in batches[3:]:
        jts.step(tuple(jnp.asarray(v) for v in b))
        ts.step(tuple(torch.tensor(v) for v in b))
    np.testing.assert_allclose(tm.weight.detach().numpy(),
                               np.asarray(jts.model.weight), rtol=1e-6)
    assert float(ts.scaler_state.scale) == float(jts.scaler_state.scale)
    assert ts.opt.step_count == int(jts.opt_state[0].step)
