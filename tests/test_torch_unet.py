"""The port's UNet training path against the JAX package: the NHWC
convolutions, the timestep embedding, the tiny UNet's forward (float32
and bfloat16, nearest and transposed-conv upsampling), every gradient of
the noise-prediction loss, the 3-step AdamW loss curve through
``build_train_step``, and the weight bridge.

Both sides hold the same weights: a numpy state dict loaded into the JAX
model and carried into the port by ``unet_from_jax_state_dict``.  The JAX fused GroupNorm runs its Pallas
kernels in interpret mode, the port its plain versions (CPU tensors); the
JAX results are computed once per module.  Tolerances, as ``max|err| /
max|ref|`` unless named: convolutions 1e-5; timestep embedding 1e-4
absolute (XLA's and PyTorch's ``exp`` differ by an ulp, up to 6.1e-5 at t
< 1000, which ``cos``/``sin`` of arguments up to 1000 carry over);
float32 forward 1e-4; bfloat16 forward 2e-2; gradients 1e-4 per
parameter; float32 loss curve ``rtol`` 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.core.rng import key_scope
from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.models.unet import UNet as JaxUNet
from paddle_ray_tpu.models.unet import UNetConfig as JaxUNetConfig
from paddle_ray_tpu.models.unet import timestep_embedding as jax_temb
from paddle_ray_tpu.nn import functional as JF
from paddle_ray_tpu.nn.layers import GroupNorm as JaxGroupNorm
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch.models import (UNet, UNetConfig, timestep_embedding,
                                         unet_loss_fn)
from paddle_ray_tpu_torch.nn import GroupNorm, functional as F
from paddle_ray_tpu_torch.optimizer import AdamW
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (unet_from_jax_state_dict,
                                          unet_to_jax_state_dict)

# tests/test_bert_unet.py's tiny UNet
TINY = dict(in_channels=4, out_channels=4, base_channels=16,
            channel_mults=(1, 2), blocks_per_level=1, attn_levels=(1,),
            num_heads=2, groups=8)
BATCH, IMG = 2, 16
LR, STEPS = 1e-3, 3


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_unet(upsample="interp", dtype=None) -> JaxUNet:
    """A JAX UNet of zeros, built from its abstract shapes (no eager
    random init: each of its shapes would compile a random op)."""
    cfg = JaxUNetConfig(**TINY, upsample=upsample, dtype=dtype)

    def build(key):
        with key_scope(key):
            return JaxUNet(cfg)
    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)


def _pair(upsample="interp", dtype=None, seed=0):
    """(JAX UNet, port UNet, state) holding one numpy state dict: weights
    ``N(0, 1 / fan_in)`` (fan_in the product of all but the first dim),
    GroupNorm weights ``1 + N(0, 0.2^2)``, biases ``N(0, 0.1^2)``."""
    jm = _jax_unet(upsample, dtype)
    r = np.random.RandomState(seed)
    state = {}
    for k, a in sorted(jm.state_dict().items()):
        if a.ndim > 1:
            a = r.randn(*a.shape) / np.sqrt(np.prod(a.shape[1:]))
        elif "norm" in k and k.endswith(".weight"):
            a = 1.0 + 0.2 * r.randn(*a.shape)
        else:
            a = 0.1 * r.randn(*a.shape)
        state[k] = a.astype(np.float32)
    jm.load_state_dict(state)
    tm = unet_from_jax_state_dict(
        UNetConfig(**TINY, upsample=upsample), state, device="cpu",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jm, tm, state


def _batch(seed=1):
    r = np.random.RandomState(seed)
    x = r.randn(BATCH, IMG, IMG, 4).astype(np.float32)
    t = np.asarray([3, 777], np.int32)
    eps = r.randn(BATCH, IMG, IMG, 4).astype(np.float32)
    return x, t, eps


def _jax_batch(batch, dtype=jnp.float32):
    x, t, eps = batch
    return jnp.asarray(x, dtype), jnp.asarray(t), jnp.asarray(eps, dtype)


def _port_batch(batch, dtype=torch.float32):
    x, t, eps = batch
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(t).long(),
            torch.from_numpy(eps).to(dtype))


def _jax_loss(m, b, rng=None):
    x, t, eps = b
    return jnp.mean((m(x, t).astype(jnp.float32)
                     - eps.astype(jnp.float32)) ** 2)


def _forward(m, x, t):
    return m(x, t)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side, computed once: the float32 loss, its output and every
    gradient (one jitted program), the deconv and bfloat16 forwards, and
    the 3-step loss curve on a one-device mesh (the process's topology is
    put back)."""
    out = {}
    batch = _batch()
    jx = _jax_batch(batch)
    jm, _, state = _pair()

    def loss_and_y(m, b):
        y = m(b[0], b[1])
        return jnp.mean((y.astype(jnp.float32)
                         - b[2].astype(jnp.float32)) ** 2), y
    (loss, y), grads = jax.jit(jax_value_and_grad(loss_and_y, has_aux=True))(
        jm, jx)
    out["interp"] = {"state": state, "y": np.asarray(y)}
    out["loss"] = float(loss)
    out["grads"] = {k: np.asarray(v) for k, v in grads.named_parameters()}
    fwd = jax.jit(_forward)
    for name, kw in (("deconv", dict(upsample="deconv")),
                     ("bf16", dict(dtype="bfloat16"))):
        m, _, st = _pair(**kw)
        b = _jax_batch(batch, jnp.bfloat16) if name == "bf16" else jx
        out[name] = {"state": st, "y": np.asarray(
            jnp.asarray(fwd(m, b[0], b[1]), jnp.float32))}
    saved = current_topology()
    try:
        topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
        ts = jax_build_train_step(jm, jax_optim.AdamW(LR), _jax_loss,
                                  topo=topo, donate=False)
        out["curve"] = [float(ts.step(jx)) for _ in range(STEPS)]
    finally:
        set_topology(saved)
    return out


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cin,cout,k,stride,padding,groups", [
    (6, 8, 3, 1, 1, 1),          # the UNet's 3x3 convs
    (8, 8, 3, 2, 1, 1),          # Downsample
    (6, 8, 1, 1, 0, 1),          # the ResBlock skip
    (6, 4, 3, 1, 2, 2),          # grouped, wider padding
])
def test_conv2d_matches_jax(cin, cout, k, stride, padding, groups):
    r = np.random.RandomState(cin + k + stride)
    x = r.randn(2, 9, 10, cin).astype(np.float32)
    w = r.randn(cout, cin // groups, k, k).astype(np.float32)
    b = r.randn(cout).astype(np.float32)
    want = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                     padding, 1, groups)
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride, padding, 1, groups)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("k,stride,padding,output_padding,groups", [
    (4, 2, 1, 0, 1),             # the UNet's "deconv" Upsample
    (3, 2, 1, 1, 1),
    (3, 1, 0, 0, 2),
])
def test_conv2d_transpose_matches_jax(k, stride, padding, output_padding,
                                      groups):
    r = np.random.RandomState(k + output_padding)
    x = r.randn(2, 9, 10, 6).astype(np.float32)
    w = r.randn(6, 4 // groups, k, k).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    want = JF.conv2d_transpose(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), stride, padding,
                               output_padding, groups)
    got = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride, padding,
                             output_padding, groups)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_unported_conv_padding_raises():
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(2, 2, 3, 3)
    for pad in ("SAME", ((1, 0), (1, 0))):
        with pytest.raises(NotImplementedError):
            F.conv2d(x, w, padding=pad)


@pytest.mark.parametrize("dim", [16, 320, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.arange(0, 1000, 7, dtype=np.int32)
    want = np.asarray(jax_temb(jnp.asarray(t), dim))
    got = timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_group_norm_module_matches_jax():
    r = np.random.RandomState(5)
    x = (2.0 * r.randn(2, 5, 6, 24) + 1.0).astype(np.float32)
    w, b = (1 + r.randn(24)).astype(np.float32), r.randn(24).astype(
        np.float32)
    jg = JaxGroupNorm(6, 24)
    jg.weight, jg.bias = jnp.asarray(w), jnp.asarray(b)
    tg = GroupNorm(6, 24)
    with torch.no_grad():
        tg.weight.copy_(torch.from_numpy(w))
        tg.bias.copy_(torch.from_numpy(b))
    assert _rel(tg(torch.from_numpy(x)), jg(jnp.asarray(x))) <= 1e-5


# ---------------------------------------------------------------------------
# the tiny UNet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["interp", "deconv", "bf16"])
def test_unet_forward_matches_jax(name, jax_ref):
    kw = {"interp": {}, "deconv": dict(upsample="deconv"),
          "bf16": dict(dtype="bfloat16")}[name]
    _, tm, _ = _pair(**kw)
    dt = torch.bfloat16 if name == "bf16" else torch.float32
    x, t, _ = _port_batch(_batch(), dt)
    with torch.no_grad():
        y = tm(x, t)
    assert y.shape == (BATCH, IMG, IMG, 4) and y.dtype == dt
    assert _rel(y, jax_ref[name]["y"]) <= (2e-2 if name == "bf16" else 1e-4)


def test_unet_every_grad_matches_jax(jax_ref):
    _, tm, _ = _pair()
    loss = unet_loss_fn(tm, _port_batch(_batch()))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), jax_ref["loss"],
                               rtol=1e-5)
    grads = jax_ref["grads"]
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(grads)
    for name, p in tm.named_parameters():
        assert _rel(p.grad, grads[name]) <= 1e-4, name


def test_unet_train_step_loss_curve_matches_jax(jax_ref):
    """Three AdamW(1e-3) steps in float32 from the same weights; AdamW
    decays the 4-D conv and 2-D linear weights, not biases or norms."""
    _, tm, _ = _pair()
    ts = build_train_step(tm, AdamW(LR), unet_loss_fn)
    batch = _port_batch(_batch())
    got = [float(ts.step(batch)) for _ in range(STEPS)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, jax_ref["curve"], rtol=1e-4)


def test_unet_weight_bridge_round_trip(jax_ref):
    state = jax_ref["interp"]["state"]
    tm = unet_from_jax_state_dict(UNetConfig(**TINY), state, device="cpu")
    back = unet_to_jax_state_dict(tm)
    assert sorted(back) == sorted(state)
    for k, a in state.items():
        assert np.array_equal(back[k], a), k
    # conv weights keep the JAX (O, I, kh, kw) shape, stored channels-last
    w = tm.downs[0]["res"].conv1.weight
    assert tuple(w.shape) == state["downs.0.res.conv1.weight"].shape
    assert w.is_contiguous(memory_format=torch.channels_last)
    missing = {k: a for k, a in state.items() if k != "stem.bias"}
    with pytest.raises(KeyError):
        unet_from_jax_state_dict(UNetConfig(**TINY), missing, device="cpu")
    extra = dict(state, **{"stem.extra": np.zeros(1, np.float32)})
    with pytest.raises(KeyError):
        unet_from_jax_state_dict(UNetConfig(**TINY), extra, device="cpu")
    wrong = dict(state, **{"stem.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        unet_from_jax_state_dict(UNetConfig(**TINY), wrong, device="cpu")


def test_unet_needs_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        UNet(UNetConfig(**TINY))
    with pytest.raises(ValueError):
        UNet(dataclasses.replace(UNetConfig(**TINY), upsample="bilinear"),
             device="cpu")
    w = UNet(UNetConfig(**TINY), device="cpu").out_norm.weight
    assert w.device.type == "cpu" and w.dtype == torch.float32
