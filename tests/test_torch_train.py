"""The port's training path against the JAX package: cross-entropy,
``GPT.loss`` with every parameter's gradient (dense and flash attention),
the AdamW update with float32 master weights, and the loss curve of
``build_train_step``.

Both sides hold the same weights: a JAX model's state dict, randomised
with numpy, carried into the port by ``gpt_from_jax_state_dict``; labels
hold ``-100`` entries, which the loss ignores.  The JAX flash attention
runs its Pallas kernels in interpret mode, the port's its plain versions
(CPU tensors).  Tolerances: float32 loss 1e-5, gradients ``rtol=1e-4,
atol=1e-5``, optimizer state 1e-6, 5-step float32 loss curve 1e-4
(summation order differs); bfloat16 parameters 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu.parallel.tp import (
    ParallelCrossEntropy as JaxParallelCrossEntropy)
from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.optimizer import Adam, AdamW, ConstantLR
from paddle_ray_tpu_torch.parallel import (ParallelCrossEntropy, TrainState,
                                           build_train_step)
from paddle_ray_tpu_torch.weights import gpt_from_jax_state_dict, to_jax_key

# the configuration of tests/test_torch_gpt.py
SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)
SEQ = 32


def _pair(seed, attn_impl="dense", dtype=None, **cfg):
    """(JAX model, port model) holding one random numpy state dict."""
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**SHAPE, attn_impl=attn_impl,
                                    dtype=dtype, **cfg))
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
        GPTConfig(**SHAPE, attn_impl=attn_impl, **cfg), state, device="cpu",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jm, tm


def _batch(seed, b=2, s=SEQ):
    r = np.random.RandomState(seed)
    ids = r.randint(0, SHAPE["vocab_size"], (b, s)).astype(np.int32)
    labels = r.randint(0, SHAPE["vocab_size"], (b, s)).astype(np.int32)
    labels[r.rand(b, s) < 0.25] = -100
    return ids, labels


@pytest.fixture
def one_device_topology():
    """A one-device JAX mesh for the JAX train step; the process's
    topology is put back afterwards."""
    saved = current_topology()
    topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    try:
        yield topo
    finally:
        set_topology(saved)


def test_cross_entropy_matches_jax():
    r = np.random.RandomState(0)
    logits = (3 * r.randn(2, 7, 97)).astype(np.float32)
    labels = r.randint(0, 97, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -100
    want = np.asarray(JaxParallelCrossEntropy()(jnp.asarray(logits),
                                                jnp.asarray(labels)))
    got = ParallelCrossEntropy()(torch.from_numpy(logits),
                                 torch.from_numpy(labels).long())
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    assert got[0, 2] == 0 and got[1, 5] == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_loss_and_every_grad_match_jax(attn_impl):
    jm, tm = _pair(1, attn_impl)
    ids, labels = _batch(2)
    loss_j, grads_j = jax_value_and_grad(
        lambda m, i, l: m.loss(i, l))(jm, jnp.asarray(ids),
                                      jnp.asarray(labels))
    grads_j = dict(grads_j.named_parameters())
    loss_t = tm.loss(torch.from_numpy(ids).long(),
                     torch.from_numpy(labels).long())
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(to_jax_key(n) for n in names) == sorted(grads_j)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(grads_j[to_jax_key(name)]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates on one 2-D and one 1-D parameter (decayed and not),
    with a float32 master for bfloat16 parameters: parameters, both
    moments and the master agree."""
    r = np.random.RandomState(3)
    init = {"w": r.randn(4, 3).astype(np.float32),
            "b": r.randn(3).astype(np.float32)}
    grads = [{k: r.randn(*a.shape).astype(np.float32)
              for k, a in init.items()} for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    opt_j = jax_optim.AdamW(1e-2)
    params_j = {k: jnp.asarray(a, jdt) for k, a in init.items()}
    state_j = opt_j.init(params_j)
    params_t = {k: torch.nn.Parameter(torch.from_numpy(a).to(tdt))
                for k, a in init.items()}
    opt_t = AdamW(1e-2, parameters=list(params_t.items()))
    for g in grads:
        params_j, state_j = opt_j.step(
            {k: jnp.asarray(a, jdt) for k, a in g.items()}, params_j,
            state_j)
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k]).to(tdt)
        opt_t.step()
    assert opt_t.step_count == int(state_j.step) == 3
    tol = dict(rtol=1e-6, atol=1e-6)
    for k, p in params_t.items():
        st = opt_t.state[p]
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(
            params_j[k].astype(jnp.float32)), err_msg=k, **tol)
        for slot in ("m", "v"):
            assert st[slot].dtype == torch.float32
            np.testing.assert_allclose(st[slot].numpy(), np.asarray(
                state_j.slots[slot][k]), err_msg=f"{k}.{slot}", **tol)
        if dtype == "bfloat16":
            np.testing.assert_allclose(st["master"].numpy(), np.asarray(
                state_j.master[k]), err_msg=f"{k}.master", **tol)
        else:
            assert "master" not in st


def test_adamw_decay_mask_and_missing_grads():
    """``wd_mask_fn`` sees the parameter names; a parameter without a
    grad is left alone while the step count still advances."""
    w = torch.nn.Parameter(torch.ones(2, 2))
    b = torch.nn.Parameter(torch.ones(2))
    seen = []
    opt = AdamW(0.1, weight_decay=0.5, parameters=[("w", w), ("b", b)],
                wd_mask_fn=lambda n: seen.append(n) or n == "b")
    w.grad = torch.zeros(2, 2)
    opt.step()
    assert seen == ["w"] and opt.step_count == 1
    # zero grad and no decay: w unchanged; b has no grad: unchanged
    assert torch.equal(w.detach(), torch.ones(2, 2))
    assert torch.equal(b.detach(), torch.ones(2))
    b.grad = torch.zeros(2)
    opt.step()
    # decayed: b -= lr * wd * b
    np.testing.assert_allclose(b.detach().numpy(), 1 - 0.1 * 0.5, rtol=1e-6)
    assert ConstantLR(0.1)(7) == 0.1
    with pytest.raises(RuntimeError):
        Adam(1e-3).step()


def _jax_losses(jm, batch, steps, lr, topo):
    ts = jax_build_train_step(jm, jax_optim.AdamW(lr), jax_gpt_loss_fn,
                              topo=topo, donate=False)
    ids, labels = (jnp.asarray(x) for x in batch)
    return [float(ts.step((ids, labels))) for _ in range(steps)]


def _port_losses(tm, batch, steps, lr):
    ts = build_train_step(tm, AdamW(lr), gpt_loss_fn)
    assert isinstance(ts, TrainState)
    ids, labels = (torch.from_numpy(x).long() for x in batch)
    losses = [ts.step((ids, labels)) for _ in range(steps)]
    assert ts.step_count == steps and ts.last_loss is losses[-1]
    return [float(x) for x in losses]


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_train_step_loss_curve_matches_jax(attn_impl, one_device_topology):
    """Five AdamW(1e-2) steps in float32 from the same weights."""
    jm, tm = _pair(4, attn_impl)
    batch = _batch(5)
    want = _jax_losses(jm, batch, 5, 1e-2, one_device_topology)
    got = _port_losses(tm, batch, 5, 1e-2)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_step_bf16_parameters_match_jax(one_device_topology):
    """bfloat16 parameters with float32 masters, three steps."""
    jm, tm = _pair(6, "dense", dtype="bfloat16")
    assert tm.dtype == torch.bfloat16
    batch = _batch(7)
    want = _jax_losses(jm, batch, 3, 1e-2, one_device_topology)
    got = _port_losses(tm, batch, 3, 1e-2)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_gives_the_same_grads(attn_impl):
    ids, labels = (torch.from_numpy(x).long() for x in _batch(8))
    grads = []
    for remat in (False, True):
        g = torch.Generator()
        g.manual_seed(9)
        m = build_gpt(GPTConfig(**SHAPE), device="cpu", generator=g,
                      attn_impl=attn_impl, remat=remat)
        gpt_loss_fn(m, (ids, labels)).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0,
                                   msg=name)


# dropout, the "dots" remat policies and ce_chunk are ported
# (tests/test_torch_train_options.py); the MoE FFN's gates take their cases
@pytest.mark.parametrize("override", [
    dict(attn_impl="ring"), dict(attn_impl="ring_flash"),
    dict(attn_impl="ulysses"), dict(moe_num_experts=4, moe_gate="switch"),
    dict(moe_num_experts=4, moe_gate="naive"),
    dict(moe_num_experts=8, moe_top_k=1), dict(moe_num_experts=2,
                                               dropout=0.1),
    dict(moe_num_experts=4)])
def test_unported_model_options_raise(override):
    cfg = dataclasses.replace(GPTConfig(**SHAPE), **override)
    with pytest.raises(NotImplementedError):
        build_gpt(cfg, device="cpu")


# grad_accum is ported (tests/test_torch_train_options.py), has_aux,
# scaler and offload_opt_state too (tests/test_torch_amp.py,
# tests/test_torch_memory_efficient.py)
@pytest.mark.parametrize("option", [
    dict(topo=object()), dict(zero_stage=1), dict(zero_stage=3),
    dict(value_and_grad_fn=lambda m, b, r: None),
    dict(comm_bucket_mb=25.0), dict(comm_dtype="int8")])
def test_unported_train_step_options_raise(option):
    m = build_gpt(GPTConfig(**SHAPE), device="cpu")
    with pytest.raises(NotImplementedError):
        build_train_step(m, AdamW(1e-3), gpt_loss_fn, **option)


def test_unported_optimizer_options_raise_and_batch_device_is_checked():
    # clips and L1Decay / L2Decay are ported: anything else is refused
    with pytest.raises(TypeError):
        AdamW(1e-3, grad_clip=object())
    with pytest.raises(TypeError):
        AdamW(1e-3, weight_decay=object())
    m = build_gpt(GPTConfig(**SHAPE), device="cpu")
    ts = build_train_step(m, AdamW(1e-3), gpt_loss_fn, donate=False)
    ids = torch.zeros(1, 8, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="batch tensor"):
        ts.step((ids, ids))


def test_unbound_step_raises_after_a_bound_instance():
    """Once an instance of a class binds, torch runs that class's ``step``
    through its hook wrapper; an unbound instance still raises the
    not-bound ``RuntimeError`` there, in any test order."""
    w = torch.nn.Parameter(torch.ones(2, 2))
    Adam(1e-3, parameters=[("w", w)])
    assert getattr(Adam.step, "hooked", False)
    with pytest.raises(RuntimeError, match="not bound"):
        Adam(1e-3).step()
