"""The port's flash attention against the JAX kernels.

The same numpy inputs go through ``paddle_ray_tpu``'s Pallas flash
attention (interpret mode on the CPU) and ``paddle_ray_tpu_torch``'s
``flash_attention``, whose kernel wrappers run their plain PyTorch
versions for CPU tensors: causal and full attention, GQA and MQA, the
forward, its logsumexp and the gradients of a random cotangent; an
additive bias (full and broadcast, with its gradient), a boolean
``attn_mask`` (a padding mask, a fully masked row), q/kv segment ids
(padding, packing, a fully masked row, with the causal mask) and the
folded functions' ``dbias``.  Tolerances: float32 outputs ``rtol=1e-4, atol=1e-5`` and float32 gradients
``rtol=1e-3, atol=1e-4`` (summation order differs), bfloat16 ``2e-2``
(the frameworks round bfloat16 intermediates at different places)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.ops import flash_attention as jax_flash
from paddle_ray_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
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


def _extras(seed, b=2, s=128, h=4):
    """The bias / mask / segment-id cases, as numpy arrays: padding
    lengths 128 and 77, a packed second sequence, a fully masked row."""
    r = np.random.RandomState(seed)
    seg = np.ones((b, s), np.int32)
    seg[0, 77:] = 0                       # padding
    seg[1, 40:] = 2                       # two packed sequences
    kv_seg = seg.copy()
    kv_seg[0, :] = 1                      # q rows of segment 0 see no key
    pad = (seg != 0)[:, None, None, :]
    row_masked = np.ones((b, 1, s, s), bool)
    row_masked[0, 0, 5, :] = False        # row 5 of batch 0 sees no key
    return {
        "bias": dict(bias=r.randn(b, h, s, s).astype(np.float32)),
        "bias_broadcast": dict(bias=r.randn(1, h, 1, s).astype(np.float32)),
        "mask_padding": dict(attn_mask=pad),
        "mask_full_row": dict(attn_mask=row_masked),
        "bias_and_mask": dict(bias=r.randn(b, h, s, s).astype(np.float32),
                              attn_mask=pad),
        "segments": dict(segment_ids=seg),
        "kv_segments_full_row": dict(segment_ids=seg, kv_segment_ids=kv_seg),
    }


EXTRA_CASES = ["bias", "bias_broadcast", "mask_padding", "mask_full_row",
               "bias_and_mask", "segments", "kv_segments_full_row"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", EXTRA_CASES)
def test_bias_mask_and_segments_match_jax(case, causal):
    """Forward and the gradients of q, k, v and (when given) the bias.  A
    row masked by segment ids averages its values over -1e30 logits, one
    masked by the -1e30 mask-bias gives zeros: finite either way, as in
    JAX."""
    q, k, v, do = _inputs(10, hkv=2, d=32)
    extra = _extras(11)[case]
    has_bias = "bias" in extra
    fixed = {n: a for n, a in extra.items() if n != "bias"}

    def jax_fn(q, k, v, *bias):
        return jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                         bias=bias[0] if bias else None,
                         **{n: jnp.asarray(a) for n, a in fixed.items()})
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    if has_bias:
        jargs.append(jnp.asarray(extra["bias"]))
    out_j, vjp = jax.vjp(jax_fn, *jargs)
    want = [np.asarray(out_j), *(np.asarray(g) for g in vjp(
        jnp.asarray(do)))]

    targs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if has_bias:
        targs.append(torch.from_numpy(extra["bias"]).requires_grad_())
    out = flash_attention(*targs[:3], causal=causal,
                          bias=targs[3] if has_bias else None,
                          **{n: torch.from_numpy(a) for n, a in fixed.items()})
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy(), *(a.grad.numpy() for a in targs)]
    assert np.isfinite(got[0]).all() and np.isfinite(want[0]).all()
    np.testing.assert_allclose(got[0], want[0], **F32_OUT)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got[1:], want[1:]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **F32_GRAD)


def test_fully_masked_rows_against_jax_forward():
    """The two fully masked rows on their own: segment ids give the mean
    of v (uniform weights), the -1e30 mask-bias zeros; lse as JAX's."""
    q, k, v, _ = _inputs(12, s=64, h=2, hkv=2)
    seg = np.ones((2, 64), np.int32)
    seg[0, :3] = 0
    kv_seg = np.ones((2, 64), np.int32)
    mask = np.ones((2, 1, 64, 64), bool)
    mask[1, 0, 7, :] = False
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(   # noqa: E731
        -1, x.shape[1], x.shape[3])
    t = lambda x: fa._fold_heads(torch.from_numpy(x))        # noqa: E731
    segs = (np.broadcast_to(seg[..., None], (2, 64, 128)),
            np.broadcast_to(kv_seg[..., None], (2, 64, 128)))
    o_j, lse_j = jax_flash_fwd(fold(q), fold(k), fold(v), None,
                               tuple(jnp.asarray(a) for a in segs), 0.125,
                               False, 64, 64, 1, True)
    o_t, lse_t = fa.flash_forward(
        t(q), t(k), t(v), causal=False, scale=0.125,
        segment_ids=(torch.from_numpy(seg), torch.from_numpy(kv_seg)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_OUT)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               rtol=1e-6)
    mean_v = v[0].mean(0)                              # [H, D]
    for head in range(2):
        np.testing.assert_allclose(o_t[head, 0].numpy(), mean_v[head],
                                   rtol=1e-5, atol=1e-5)
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=False, attn_mask=torch.from_numpy(mask))
    assert torch.equal(out[1, 7], torch.zeros_like(out[1, 7]))
    assert torch.isfinite(out).all()


def test_folded_dbias_matches_jax():
    """``flash_backward_dq(need_dbias=True)`` gives the JAX dq kernel's
    dbias output, causal (zeros above the diagonal) and full; the
    autograd path sums it back to a broadcast bias's shape."""
    q, k, v, do = _inputs(13, s=128, h=4, hkv=4, d=32)
    bias = np.random.RandomState(14).randn(2, 4, 128, 128).astype(np.float32)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(   # noqa: E731
        -1, x.shape[1], x.shape[3])
    t = lambda x: fa._fold_heads(torch.from_numpy(x))        # noqa: E731
    for causal in (True, False):
        jb = jnp.asarray(bias).reshape(8, 128, 128)
        o, lse = jax_flash_fwd(fold(q), fold(k), fold(v), jb, None, 0.125,
                               causal, 64, 64, 1, True)
        _, _, _, dbias_j = jax_flash_bwd(
            fold(q), fold(k), fold(v), jb, None, o, lse, fold(do), 0.125,
            causal, 64, 64, 1, True, True)
        tb = torch.from_numpy(bias)
        o_t, lse_t = fa.flash_forward(t(q), t(k), t(v), causal=causal,
                                      scale=0.125, bias=tb)
        dq, dk, dv, dbias = fa.flash_backward(
            t(q), t(k), t(v), o_t, lse_t, t(do), causal=causal, scale=0.125,
            bias=tb, need_dbias=True)
        assert dbias.shape == (8, 128, 128) and dbias.dtype == torch.float32
        np.testing.assert_allclose(dbias.numpy(), np.asarray(dbias_j),
                                   **F32_GRAD)
        if causal:
            upper = np.triu(np.ones((128, 128), bool), 65)
            assert (dbias.numpy()[:, upper] == 0).all()
    # a [1, H, 1, S] bias: its gradient is dbias summed over B and rows
    small = torch.from_numpy(bias[:1, :, :1]).requires_grad_()
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=False, bias=small, scale=0.125)
    out.backward(torch.from_numpy(do))
    wide = small.detach().expand(2, 4, 128, 128)
    o_t, lse_t = fa.flash_forward(t(q), t(k), t(v), causal=False,
                                  scale=0.125, bias=wide)
    *_, full = fa.flash_backward(t(q), t(k), t(v), o_t, lse_t, t(do),
                                 causal=False, scale=0.125, bias=wide,
                                 need_dbias=True)
    want = full.reshape(2, 4, 128, 128).sum((0, 2), keepdim=True)
    np.testing.assert_allclose(small.grad.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bf16_segments_match_jax():
    q, k, v, do = _inputs(15, hkv=2)
    seg = _extras(16)["segments"]["segment_ids"]

    def run_jax(q, k, v):
        return jax_flash(q, k, v, causal=False, block_q=64, block_k=64,
                         segment_ids=jnp.asarray(seg))
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out, vjp = jax.vjp(run_jax, *args)
    want = [np.asarray(x.astype(jnp.float32))
            for x in (out, *vjp(jnp.asarray(do, jnp.bfloat16)))]
    targs = [torch.from_numpy(x).bfloat16().requires_grad_()
             for x in (q, k, v)]
    o = flash_attention(*targs, causal=False,
                        segment_ids=torch.from_numpy(seg))
    o.backward(torch.from_numpy(do).bfloat16())
    got = [x.detach().float().numpy() for x in (o, *(a.grad for a in targs))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BF16)


def test_cpu_tensors_launch_no_kernel():
    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    before = [c.launches for c in counters]
    q, k, v, do = _inputs(7, s=64, hkv=1)
    _port_vjp(q, k, v, do, True)
    assert [c.launches for c in counters] == before
