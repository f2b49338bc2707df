"""The port's flash attention against the JAX kernels.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas flash
attention (interpret mode on the CPU) and ``paddle_ray_tpu_torch``'s
``flash_attention``, whose kernel wrappers run their plain PyTorch
versions for CPU tensors: causal and full attention, GQA and MQA, the
forward, its logsumexp and the gradients of a random cotangent.
Tolerances: float32 outputs ``rtol=1e-4, atol=1e-5`` and float32 gradients
``rtol=1e-3, atol=1e-4`` (summation order differs), bfloat16 ``2e-2``
(the frameworks round bfloat16 intermediates at different places)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.ops import flash_attention as jax_flash
from paddle_ray_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from paddle_ray_tpu_torch.ops import flash_attention

fa = importlib.import_module("paddle_ray_tpu_torch.ops.flash_attention")

F32_OUT = dict(rtol=1e-4, atol=1e-5)
F32_GRAD = dict(rtol=1e-3, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b=2, s=128, h=4, hkv=4, d=64, skv=None):
    r = np.random.RandomState(seed)
    skv = skv or s
    q = r.randn(b, s, h, d).astype(np.float32)
    k = r.randn(b, skv, hkv, d).astype(np.float32)
    v = r.randn(b, skv, hkv, d).astype(np.float32)
    do = r.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=64, block_k=64), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_vjp(q, k, v, do, causal, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*args, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    out.backward(torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy()
            for x in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax(causal, hkv):
    q, k, v, do = _inputs(0, hkv=hkv)
    want = _jax_vjp(q, k, v, do, causal)
    got = _port_vjp(q, k, v, do, causal)
    np.testing.assert_allclose(got[0], want[0], **F32_OUT)
    for name, g, w in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **F32_GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax(causal):
    q, k, v, _ = _inputs(1, hkv=2)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(   # noqa: E731
        -1, x.shape[1], x.shape[3])
    scale = 1.0 / 8.0
    o_j, lse_j = jax_flash_fwd(fold(q), fold(k), fold(v), None, None, scale,
                               causal, 64, 64, 2, True)
    t = lambda x: fa._fold_heads(torch.from_numpy(x))        # noqa: E731
    o_t, lse_t = fa.flash_forward(t(q), t(k), t(v), causal=causal,
                                  scale=scale)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (8, 128)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               **F32_OUT)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_OUT)


def test_kv_longer_than_q_full_attention():
    """S != Skv, full attention only: the top-left causal mask of the
    kernels and the dense path's bottom-right mask differ there, and the
    JAX tests exercise only the full case."""
    q, k, v, do = _inputs(2, s=64, skv=192, hkv=2)
    want = _jax_vjp(q, k, v, do, False)
    got = _port_vjp(q, k, v, do, False)
    np.testing.assert_allclose(got[0], want[0], **F32_OUT)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **F32_GRAD)


def test_bf16_matches_jax():
    q, k, v, do = _inputs(3, hkv=2)
    want = _jax_vjp(q, k, v, do, True, jnp.bfloat16)
    got = _port_vjp(q, k, v, do, True, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BF16)


def test_backward_functions_match_the_vjp():
    """``flash_backward`` (delta, then the dq and dk/dv wrappers) gives
    what autograd gives through ``flash_attention``."""
    q, k, v, do = _inputs(4, hkv=2)
    got = _port_vjp(q, k, v, do, True)
    t = lambda x: fa._fold_heads(torch.from_numpy(x))        # noqa: E731
    o, lse = fa.flash_forward(t(q), t(k), t(v), causal=True, scale=0.125)
    dq, dk, dv = fa.flash_backward(t(q), t(k), t(v), o, lse, t(do),
                                   causal=True, scale=0.125)
    for g, w in zip((dq, dk, dv), got[1:]):
        want = torch.from_numpy(w).transpose(1, 2).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_sequence_not_divisible_raises_on_both_sides():
    q, k, v, _ = _inputs(5, s=100)
    with pytest.raises(ValueError, match="divisible"):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=64, block_k=64)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        block_q=64, block_k=64)
    # the kernels' own tile (64) is the default
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))


@pytest.mark.parametrize("option", ["bias", "attn_mask", "segment_ids",
                                    "kv_segment_ids"])
def test_unported_options_raise(option):
    q, k, v, _ = _inputs(6, s=64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    extra = {"bias": torch.zeros(2, 4, 64, 64),
             "attn_mask": torch.ones(2, 4, 64, 64, dtype=torch.bool),
             "segment_ids": torch.zeros(2, 64, dtype=torch.int32),
             "kv_segment_ids": torch.zeros(2, 64, dtype=torch.int32)}
    with pytest.raises(NotImplementedError):
        flash_attention(*t, **{option: extra[option]})


def test_cpu_tensors_launch_no_kernel():
    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    before = [c.launches for c in counters]
    q, k, v, do = _inputs(7, s=64, hkv=1)
    _port_vjp(q, k, v, do, True)
    assert [c.launches for c in counters] == before
