"""The port's GPT pretraining options against the JAX package: dropout
under a key, the ``"dots"`` / ``"dots_attn"`` remat policies, chunked
cross-entropy, the three gradient clips, L1 / L2 decay, all 17
learning-rate schedules, gradient accumulation, the optimizer state
carried over mid-curve, and the whole recipe's loss curve.

Both sides hold the same weights (a JAX model's state dict, randomised
with numpy, carried into the port); labels hold ``-100`` entries.  The
JAX flash attention runs its Pallas kernels in interpret mode, the port's
its plain versions (CPU tensors).  Tolerances, those of
``tests/test_torch_train.py``: float32 loss 1e-5, gradients ``rtol=1e-4,
atol=1e-5``, optimizer state 1e-6, five-step loss curves 1e-4 (summation
order differs).  A schedule's float32 value within 2e-6 of JAX's,
relative to the value or to the schedule's largest value (numpy's ``cos``
/ ``exp`` / ``pow`` against XLA's, a few ulps, which ``1 - cos`` near 0
magnifies relative to the value); the
port's remat policies against the port without remat: equal bits (the
recompute runs the same operators)."""
import contextlib
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_ray_tpu as prt
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu import regularizer as jax_reg
from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from paddle_ray_tpu.optimizer import lr as jax_lr
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch import regularizer as reg
from paddle_ray_tpu_torch.core import prng
from paddle_ray_tpu_torch.core import rng as trng
from paddle_ray_tpu_torch.models import gpt_loss_fn
from paddle_ray_tpu_torch.models.gpt import GPTConfig, remat
from paddle_ray_tpu_torch.nn import Dropout, Linear
from paddle_ray_tpu_torch.optimizer import (Adam, AdamW, ClipGradByGlobalNorm,
                                            ClipGradByNorm, ClipGradByValue,
                                            CosineAnnealingDecay,
                                            LinearWarmup, ReduceOnPlateau)
from paddle_ray_tpu_torch.optimizer import lr as tlr
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          optimizer_from_jax_state,
                                          to_jax_key)

D = importlib.import_module("paddle_ray_tpu_torch.ops.dropout")
FA = importlib.import_module("paddle_ray_tpu_torch.ops.flash_attention")

# the configuration of tests/test_torch_train.py, with dropout
SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.1)
SEQ = 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(seed, attn_impl="dense", dtype=None, **cfg):
    """(JAX model, port model) holding one random numpy state dict."""
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**{**SHAPE, **cfg}, attn_impl=attn_impl,
                                    dtype=dtype))
    r = np.random.RandomState(seed)
    state = {}
    for k, a in jm.state_dict().items():
        a = np.asarray(a, np.float32)
        if k.endswith(("ln1.weight", "ln2.weight", "norm.weight")):
            state[k] = (1.0 + 0.1 * r.randn(*a.shape)).astype(np.float32)
        else:
            state[k] = (0.1 * r.randn(*a.shape)).astype(np.float32)
    jm.load_state_dict(state)
    tm = gpt_from_jax_state_dict(
        GPTConfig(**{**SHAPE, **cfg}, attn_impl=attn_impl), state,
        device="cpu",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jm, tm


def _batch(seed, b=2, s=SEQ):
    r = np.random.RandomState(seed)
    ids = r.randint(0, SHAPE["vocab_size"], (b, s)).astype(np.int32)
    labels = r.randint(0, SHAPE["vocab_size"], (b, s)).astype(np.int32)
    labels[r.rand(b, s) < 0.25] = -100
    return ids, labels


def _torch_batch(batch):
    return tuple(torch.from_numpy(x).long() for x in batch)


@pytest.fixture
def one_device_topology():
    saved = current_topology()
    topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    try:
        yield topo
    finally:
        set_topology(saved)


def _jax_grads(jm, batch, key):
    ids, labels = (jnp.asarray(x) for x in batch)
    loss, grads = jax_value_and_grad(
        lambda m, i, l: m.loss(i, l, rng=key))(jm, ids, labels)
    return float(loss), dict(grads.named_parameters())


def _port_grads(tm, batch, key):
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(*_torch_batch(batch), rng=key)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in tm.named_parameters()}


def _assert_grads_match(got, want):
    assert sorted(to_jax_key(n) for n in got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(
            want[to_jax_key(name)]), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_dropout_loss_and_every_grad_match_jax(attn_impl):
    jm, tm = _pair(1, attn_impl)
    batch = _batch(2)
    loss_j, grads_j = _jax_grads(jm, batch, jax.random.PRNGKey(7))
    loss_t, grads_t = _port_grads(tm, batch, prng.PRNGKey(7))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    _assert_grads_match(grads_t, grads_j)
    # dropout changed the loss, and without a key nothing is dropped
    loss_0, _ = _port_grads(tm, batch, None)
    assert abs(loss_0 - loss_t) > 1e-4
    tm.eval()
    assert float(tm.loss(*_torch_batch(batch), rng=prng.PRNGKey(7))) == \
        pytest.approx(loss_0, rel=1e-6)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_remat_policy_grads_match_jax_and_no_remat(policy, attn_impl):
    jm, tm = _pair(3, attn_impl, remat=True, remat_policy=policy)
    _, plain = _pair(3, attn_impl, remat=False)
    batch = _batch(4)
    loss_j, grads_j = _jax_grads(jm, batch, jax.random.PRNGKey(5))
    loss_t, grads_t = _port_grads(tm, batch, prng.PRNGKey(5))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    _assert_grads_match(grads_t, grads_j)
    loss_p, grads_p = _port_grads(plain, batch, prng.PRNGKey(5))
    assert loss_p == loss_t
    for name, g in grads_p.items():
        assert torch.equal(grads_t[name], g), name


def _counting(monkeypatch):
    """Count the plain dropout and flash-forward calls (the kernels' CPU
    stand-ins): the launch pattern each policy gives on the card."""
    calls = {"dropout": 0, "flash_fwd": 0}
    drop, fwd = D.dropout_plain, FA.flash_forward_plain

    def count_drop(*a, **k):
        calls["dropout"] += 1
        return drop(*a, **k)

    def count_fwd(*a, **k):
        calls["flash_fwd"] += 1
        return fwd(*a, **k)

    monkeypatch.setattr(D, "dropout_plain", count_drop)
    monkeypatch.setattr(FA, "flash_forward_plain", count_fwd)
    return calls


@pytest.mark.parametrize("policy", ["off", "none", "dots", "dots_attn"])
def test_remat_launch_pattern(policy, monkeypatch):
    """Per step of L layers: dropout 1 + 2 L forward and backward, and L
    more in the recompute (a block's attention-output drop, which the
    second norm's input needs; the recompute stops before the MLP's);
    the flash forward once a layer, twice when the policy recomputes it
    (``"none"``, ``"dots"``)."""
    kw = (dict(remat=False) if policy == "off"
          else dict(remat=True, remat_policy=policy))
    _, tm = _pair(5, "flash", **kw)
    calls = _counting(monkeypatch)
    _port_grads(tm, _batch(6), prng.PRNGKey(1))
    n = SHAPE["num_layers"]
    recomputed = 0 if policy == "off" else n
    assert calls["dropout"] == 2 * (1 + 2 * n) + recomputed
    assert calls["flash_fwd"] == n * (2 if policy in ("none", "dots")
                                      else 1)


class _Watch(TorchDispatchMode):
    """A dispatch mode that only passes each op on, as a remat policy's
    does before it decides what to keep."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("watched", [False, True])
def test_flash_forward_is_one_operator_under_a_dispatch_mode(watched,
                                                             monkeypatch):
    """Under a dispatch mode the flash forward is the operator
    ``prt::flash_attention_fwd``, which a remat policy can keep; outside
    one it is an ``autograd.Function`` (less host work a call).  Both give
    the same output and gradients."""
    calls = []
    op = FA.flash_op

    def counted(*a):
        calls.append(1)
        return op(*a)
    monkeypatch.setattr(FA, "flash_op", counted)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, 2, 16, generator=g) for _ in range(3))
    do = torch.randn(2, 64, 2, 16, generator=g)
    outs = []
    for watch in (False, watched):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with _Watch() if watch else contextlib.nullcontext():
            o = FA.flash_attention(*leaves, causal=True)
        o.backward(do)
        outs.append([o.detach()] + [t.grad for t in leaves])
    assert len(calls) == int(watched)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


class _DropBlock(torch.nn.Module):
    """Two linears around a ``Dropout`` that draws its own key."""

    def __init__(self):
        super().__init__()
        g = torch.Generator()
        g.manual_seed(0)
        self.a = Linear(16, 16, generator=g)
        self.b = Linear(16, 16, generator=g)
        self.drop = Dropout(0.5)

    def forward(self, x):
        return self.b(torch.tanh(self.drop(self.a(x))))


@pytest.mark.parametrize("policy", ["none", "dots", "dots_attn"])
@pytest.mark.parametrize("scope", [True, False])
def test_checkpointed_block_replays_its_key_draws(policy, scope):
    """A checkpointed block whose ``Dropout`` draws from ``key_scope`` (or
    the tracker): the recompute gets the forward's keys, so the gradients
    equal the no-remat ones."""
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    grads = []
    for wrap in (lambda f: f, lambda f: remat(f, policy)):
        blk = _DropBlock()
        trng.seed(3)
        with (trng.key_scope(prng.PRNGKey(9)) if scope
              else torch.enable_grad()):
            y = wrap(lambda t: blk(t) + blk(t))(x)
            after = trng.next_key()
        y.square().sum().backward()
        grads.append(([p.grad for p in blk.parameters()], after))
    for g, want in zip(grads[1][0], grads[0][0]):
        assert torch.equal(g, want)
    assert torch.equal(grads[1][1], grads[0][1])


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_ce_chunk_loss_and_grads_match_jax(attn_impl):
    jm, tm = _pair(7, attn_impl, ce_chunk=8)
    _, full = _pair(7, attn_impl)
    batch = _batch(8)
    loss_j, grads_j = _jax_grads(jm, batch, jax.random.PRNGKey(2))
    loss_t, grads_t = _port_grads(tm, batch, prng.PRNGKey(2))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    _assert_grads_match(grads_t, grads_j)
    loss_f, grads_f = _port_grads(full, batch, prng.PRNGKey(2))
    np.testing.assert_allclose(loss_t, loss_f, rtol=1e-5, atol=1e-5)
    for name, g in grads_f.items():
        np.testing.assert_allclose(grads_t[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)
    with pytest.raises(ValueError, match="ce_chunk"):
        tm.loss(*_torch_batch(_batch(8, s=20)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [("global", 1.0), ("global", 100.0),
                                  ("norm", 0.5), ("value", 0.3)])
def test_clips_match_jax(clip, dtype):
    kind, c = clip
    r = np.random.RandomState(9)
    grads = {k: r.randn(*s).astype(np.float32)
             for k, s in (("a", (5, 7)), ("b", (7,)), ("c", (3, 2, 4)))}
    jcls, tcls = {"global": (jax_optim.ClipGradByGlobalNorm,
                             ClipGradByGlobalNorm),
                  "norm": (jax_optim.ClipGradByNorm, ClipGradByNorm),
                  "value": (jax_optim.ClipGradByValue, ClipGradByValue)}[kind]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcls(c)({k: jnp.asarray(g, jdt) for k, g in grads.items()})
    got = tcls(c)([torch.from_numpy(g).to(tdt) for g in grads.values()]
                  + [None])
    assert got[-1] is None
    tol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
           else dict(rtol=0, atol=0))
    for g, k in zip(got, grads):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), np.asarray(
            want[k].astype(jnp.float32)), err_msg=k, **tol)


@pytest.mark.parametrize("decay", ["l1", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_l2_decay_match_jax(decay, dtype):
    """Three Adam updates with a coupled regularizer on one 2-D and one
    1-D parameter (decayed and not, by the default mask), a float32
    master for bfloat16, and a global-norm clip."""
    r = np.random.RandomState(10)
    init = {"w": r.randn(4, 3).astype(np.float32),
            "b": r.randn(3).astype(np.float32)}
    grads = [{k: r.randn(*a.shape).astype(np.float32)
              for k, a in init.items()} for _ in range(3)]
    jreg = (jax_reg.L1Decay if decay == "l1" else jax_reg.L2Decay)(0.05)
    treg = (reg.L1Decay if decay == "l1" else reg.L2Decay)(0.05)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    opt_j = jax_optim.Adam(1e-2, weight_decay=jreg,
                           grad_clip=jax_optim.ClipGradByGlobalNorm(1.0))
    params_j = {k: jnp.asarray(a, jdt) for k, a in init.items()}
    state_j = opt_j.init(params_j)
    params_t = {k: torch.nn.Parameter(torch.from_numpy(a).to(tdt))
                for k, a in init.items()}
    opt_t = Adam(1e-2, weight_decay=treg,
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 parameters=list(params_t.items()))
    for g in grads:
        params_j, state_j = opt_j.step(
            {k: jnp.asarray(a, jdt) for k, a in g.items()}, params_j,
            state_j)
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k]).to(tdt)
        opt_t.step()
    tol = dict(rtol=1e-6, atol=1e-6)
    for k, p in params_t.items():
        st = opt_t.state[p]
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(
            params_j[k].astype(jnp.float32)), err_msg=k,
            **(tol if dtype == "float32" else dict(rtol=0, atol=0)))
        for slot in ("m", "v"):
            np.testing.assert_allclose(st[slot].numpy(), np.asarray(
                state_j.slots[slot][k]), err_msg=f"{k}.{slot}", **tol)


def test_optimizer_refuses_what_it_does_not_take():
    with pytest.raises(TypeError, match="grad_clip"):
        AdamW(1e-3, grad_clip=object())
    with pytest.raises(TypeError, match="weight_decay"):
        AdamW(1e-3, weight_decay="0.1")


def _lam(s):
    return 1.0 / (1.0 + 0.01 * s)


SCHEDULES = {
    "ConstantLR": lambda m: m.ConstantLR(0.1),
    "StepDecay": lambda m: m.StepDecay(0.1, 30, 0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [20, 90, 200], 0.3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.99),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 250, 1e-4, 2.0),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(6e-4, 280,
                                                             6e-5),
    "NoamDecay": lambda m: m.NoamDecay(512, 40, 2.0),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(6e-4, 250, 6e-5), 30),
    "LinearWarmup_end": lambda m: m.LinearWarmup(0.1, 50, 0.01, 0.2),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 260),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 100], [0.1, 0.05,
                                                             0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.01),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.05),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, _lam),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda s: 0.99),
    "CyclicLR": lambda m: m.CyclicLR(1e-3, 1e-2, 40, 25),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(1e-3, 1e-2, 30,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(1e-3, 1e-2, 30,
                                               mode="exp_range",
                                               exp_gamma=0.995),
    "CyclicLR_scale_fn": lambda m: m.CyclicLR(
        1e-3, 1e-2, 30, scale_fn=lambda c: 1.0 / c),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_300_steps(name):
    jsched, tsched = SCHEDULES[name](jax_lr), SCHEDULES[name](tlr)
    jit = jax.jit(lambda s: jnp.asarray(jsched(s), jnp.float32))
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.array([float(jit(s)) for s in steps], np.float32)
    got = np.array([tsched(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-6,
                               atol=2e-6 * np.abs(want).max())
    assert np.unique(got).size > (1 if name != "ConstantLR" else 0)


def test_every_jax_schedule_is_ported():
    names = {n.split("_")[0] for n in SCHEDULES} | {"ReduceOnPlateau"}
    assert names == set(jax_lr.__all__) - {"LRScheduler"}
    assert set(tlr.__all__) == set(jax_lr.__all__)


def test_reduce_on_plateau_and_set_lr(one_device_topology):
    """The host-side state machine against JAX's over 300 metrics, and
    ``set_lr`` moving both train steps' learning rate alike."""
    kw = dict(factor=0.5, patience=3, cooldown=2, threshold=1e-3,
              min_lr=1e-4)
    js, ts_ = jax_lr.ReduceOnPlateau(0.1, **kw), tlr.ReduceOnPlateau(0.1, **kw)
    r = np.random.RandomState(11)
    metrics = np.cumsum(r.randn(300)) * 0.1 + np.linspace(5, 0, 300)
    for m in metrics:
        assert ts_.step(m) == js.step(m)
        assert ts_(0) == float(js(jnp.int32(0)))
    assert ts_.state_dict() == js.state_dict()
    jm, tm = _pair(12, "dense", dropout=0.0)
    batch = _batch(13)
    jts = jax_build_train_step(jm, jax_optim.AdamW(jax_lr.ReduceOnPlateau(
        1e-2)), jax_gpt_loss_fn, topo=one_device_topology, donate=False)
    tts = build_train_step(tm, AdamW(tlr.ReduceOnPlateau(1e-2)), gpt_loss_fn)
    got, want = [], []
    for lr in (None, 5e-3, None, 1e-3):
        if lr is not None:
            jts.set_lr(lr)
            tts.set_lr(lr)
        want.append(float(jts.step(tuple(jnp.asarray(x) for x in batch))))
        got.append(float(tts.step(_torch_batch(batch))))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(ValueError, match="host-driven"):
        build_train_step(tm, AdamW(1e-3), gpt_loss_fn).set_lr(1e-3)


def _jax_curve(jm, batch, steps, opt, topo, **kw):
    ts = jax_build_train_step(jm, opt, jax_gpt_loss_fn, topo=topo,
                              donate=False, **kw)
    ids, labels = (jnp.asarray(x) for x in batch)
    return [float(ts.step((ids, labels), jax.random.fold_in(
        jax.random.PRNGKey(0), i))) for i in range(steps)], ts


def _port_curve(tm, batch, steps, opt, **kw):
    ts = build_train_step(tm, opt, gpt_loss_fn, **kw)
    return [float(ts.step(_torch_batch(batch), prng.fold_in(
        prng.PRNGKey(0), i))) for i in range(steps)], ts


@pytest.mark.parametrize("grad_accum", [2, 4])
def test_grad_accum_curve_matches_jax(grad_accum, one_device_topology):
    """Five AdamW(1e-2) steps with dropout, batch 4 in ``grad_accum``
    micro-batches, each under its split key."""
    jm, tm = _pair(14, "dense")
    batch = _batch(15, b=4)
    want, _ = _jax_curve(jm, batch, 5, jax_optim.AdamW(1e-2),
                         one_device_topology, grad_accum=grad_accum)
    got, _ = _port_curve(tm, batch, 5, AdamW(1e-2), grad_accum=grad_accum)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_grad_accum_of_whole_rows_equals_one_batch_without_dropout():
    """Without dropout, two micro-batches of 2 rows give the gradients of
    one batch of 4 rows (each micro loss a mean over its valid labels:
    equal counts per half here) within float32 rounding."""
    _, a = _pair(16, "dense", dropout=0.0)
    _, b = _pair(16, "dense", dropout=0.0)
    ids, labels = _batch(17, b=4)
    labels[:] = np.abs(labels)          # every label valid
    batch = (ids, labels)
    build_train_step(a, Adam(0.0), gpt_loss_fn, grad_accum=2).step(
        _torch_batch(batch))
    build_train_step(b, Adam(0.0), gpt_loss_fn).step(_torch_batch(batch))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="grad_accum"):
        build_train_step(a, Adam(0.0), gpt_loss_fn, grad_accum=3).step(
            _torch_batch(batch))
    with pytest.raises(ValueError, match="grad_accum"):
        build_train_step(a, Adam(0.0), gpt_loss_fn, grad_accum=0)


def _recipe_opts(total=10):
    """GPT-3's optimizer settings (Brown et al. 2020, app. B) at toy
    length: warm-up, cosine decay to 10 %, beta2 0.95, decay 0.1, clip
    1.0."""
    def make(lr_mod, optim, clip_cls):
        return optim.AdamW(
            lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(
                1e-2, total, 1e-3), 2), beta2=0.95, weight_decay=0.1,
            grad_clip=clip_cls(1.0))
    return (make(jax_lr, jax_optim, jax_optim.ClipGradByGlobalNorm),
            make(tlr, importlib.import_module(
                "paddle_ray_tpu_torch.optimizer"), ClipGradByGlobalNorm))


def test_recipe_curve_matches_jax(one_device_topology):
    """The slice's recipe at toy size: dropout 0.1 under a step key, flash
    attention, remat ``"dots"``, ``ce_chunk`` 8, ``grad_accum`` 2, the
    clipped, decayed, scheduled AdamW: five steps."""
    cfg = dict(remat=True, remat_policy="dots", ce_chunk=8)
    jm, tm = _pair(18, "flash", **cfg)
    batch = _batch(19, b=4)
    jopt, topt = _recipe_opts()
    want, _ = _jax_curve(jm, batch, 5, jopt, one_device_topology,
                         grad_accum=2)
    got, ts = _port_curve(tm, batch, 5, topt, grad_accum=2)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert ts.opt.step_count == 5


def test_resume_mid_curve_from_jax_state(one_device_topology):
    """Three JAX steps, then the weights, the step count and both moments
    carried into the port: two more steps on each side agree."""
    jm, _ = _pair(20, "dense")
    batch = _batch(21, b=4)
    jopt, topt = _recipe_opts()
    first, jts = _jax_curve(jm, batch, 3, jopt, one_device_topology)
    state = {k: np.asarray(v, np.float32)
             for k, v in jts.model.state_dict().items()}
    opt_state = jts.opt_state
    tm = gpt_from_jax_state_dict(GPTConfig(**SHAPE), state, device="cpu",
                                 dtype=torch.float32)
    topt.bind(tm.named_parameters())
    optimizer_from_jax_state(
        topt, int(opt_state.step),
        {s: {k: np.asarray(v) for k, v in
             opt_state.slots[s].named_parameters()}
         for s in ("m", "v")})
    assert topt.step_count == 3
    ids, labels = (jnp.asarray(x) for x in batch)
    want = [float(jts.step((ids, labels), jax.random.fold_in(
        jax.random.PRNGKey(0), i))) for i in (3, 4)]
    ts = build_train_step(tm, topt, gpt_loss_fn)
    got = [float(ts.step(_torch_batch(batch), prng.fold_in(
        prng.PRNGKey(0), i))) for i in (3, 4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] < first[0]


def test_config_options_no_longer_raise():
    from paddle_ray_tpu_torch.models import build_gpt
    for override in (dict(dropout=0.1), dict(remat_policy="dots"),
                     dict(remat_policy="dots_attn"), dict(ce_chunk=16)):
        cfg = dataclasses.replace(GPTConfig(**SHAPE), **override)
        build_gpt(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        build_gpt(dataclasses.replace(GPTConfig(**SHAPE),
                                      remat_policy="everything"),
                  device="cpu")
    assert math.isclose(CosineAnnealingDecay(1.0, 10)(10), 0.0,
                        abs_tol=1e-7)
    assert LinearWarmup(1.0, 4)(2) == 0.5
    assert ReduceOnPlateau(0.3).host_driven
