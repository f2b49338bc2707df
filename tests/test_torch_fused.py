"""The port's fused dropout-add-LayerNorm and the random bits it draws,
against the JAX package.

The same numpy inputs go through ``paddle_ray_tpu``'s
``fused_dropout_add_layernorm`` (its Pallas kernels in interpret mode on
the CPU) and ``paddle_ray_tpu_torch``'s, whose kernel wrappers run their
plain PyTorch versions for CPU tensors.  Bit for bit: the keep mask
(``keep_mask_plain`` against ``_keep_mask``), ``prng.randint`` and
``prng.bernoulli`` against ``jax.random`` (one host key, which hashes on
Python integers, and batches of keys, which hash on tensors) and the masks
of ``F.dropout``.  Within tolerance: the forward ``(y, h)`` and the
gradients of x, residual, weight and bias, float32 within ``atol`` 1e-5
(XLA and PyTorch sum a row in different orders); bfloat16 ``y`` and ``h``
within one bfloat16 rounding step of each value (one ulp, ``rtol``
2**-7: the two frameworks may round ``x * mask + residual`` differently),
bfloat16 gradients within one rounding step of the tensor's largest value
(``2**-7 * max|ref|``: a ``h`` one ulp apart feeds the backward, whose
differences cancel to values near 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.nn import functional as JF
from paddle_ray_tpu.ops import fused as jax_fused
from paddle_ray_tpu_torch.core import prng
from paddle_ray_tpu_torch.nn import Dropout, functional as F
from paddle_ray_tpu_torch.ops import fused

F32 = dict(rtol=0, atol=1e-5)
BF16 = dict(rtol=2.0 ** -7, atol=1e-5)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.0, 0.9])
@pytest.mark.parametrize("seed,row0", [(0, 0), (12345, 256), (2 ** 31 - 2, 7)])
def test_keep_mask_bit_exact(p, seed, row0):
    want = np.asarray(jax_fused._keep_mask((37, 130), p, seed, row0))
    got = fused.keep_mask_plain((37, 130), p, seed, row0)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi,shape", [
    (0, 2 ** 31 - 1, (1,)),        # the dropout-add-LN seed
    (0, 10, (7,)), (-5, 1000, (3, 4)), (5, 5, (2,)),
    (-2 ** 31, 2 ** 31 - 1, (9,)), (0, 3 ** 19, (40,))])
def test_randint_bit_exact(lo, hi, shape):
    for seed in range(8):
        k, kd = _key(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi, jnp.int32))
        got = prng.randint(kd, shape, lo, hi)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (seed, lo, hi)
    keys = jax.random.split(jax.random.PRNGKey(99), 16)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, shape, lo, hi, jnp.int32))(keys))
    got = prng.randint(np.asarray(jax.random.key_data(keys)), shape, lo, hi)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(OverflowError):
        prng.randint(kd, shape, 0, 2 ** 31)


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1])
def test_bernoulli_bit_exact(p):
    for seed in range(4):
        k, kd = _key(seed)
        want = np.asarray(jax.random.bernoulli(k, p, (5, 33)))
        assert np.array_equal(prng.bernoulli(kd, p, (5, 33)).numpy(), want)
    # a split and a fold-in of one host key (Python integers) agree with
    # the tensor path and with JAX
    k, kd = _key(7)
    assert np.array_equal(prng.split(kd, 3).numpy(),
                          np.asarray(jax.random.key_data(
                              jax.random.split(k, 3))))
    assert np.array_equal(prng.fold_in(kd, 11).numpy(), np.asarray(
        jax.random.key_data(jax.random.fold_in(k, 11))))
    assert np.array_equal(prng.fold_in(kd, torch.tensor(11)).numpy(),
                          prng.fold_in(kd, 11).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_matches_jax(dtype, mode):
    r = np.random.RandomState(0)
    x = r.randn(6, 50).astype(np.float32)
    k, kd = _key(3)
    want = JF.dropout(jnp.asarray(x, dtype), 0.3, training=True, rng=k,
                      mode=mode)
    got = F.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), 0.3,
                    training=True, rng=kd, mode=mode)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(got, want)
    # eval, or p = 0: x itself
    t = torch.from_numpy(x)
    assert F.dropout(t, 0.3, training=False) is t
    assert F.dropout(t, 0.0, training=True) is t
    layer = Dropout(0.3).eval()
    assert layer(t, rng=kd) is t


def test_dropout_without_key_raises():
    with pytest.raises(NotImplementedError, match="core/rng.py"):
        F.dropout(torch.ones(3), 0.5, training=True)
    with pytest.raises(NotImplementedError, match="core/rng.py"):
        fused.fused_dropout_add_layernorm(
            torch.ones(2, 4), torch.ones(2, 4), torch.ones(4),
            torch.zeros(4), p=0.1, training=True)
    # no key needed without dropout
    y, h = fused.fused_dropout_add_layernorm(
        torch.ones(2, 4), torch.ones(2, 4), torch.ones(4), torch.zeros(4),
        p=0.1, training=False)
    assert torch.equal(h, 2 * torch.ones(2, 4))


def _inputs(rows, hdim, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(rows, hdim).astype(np.float32)
    res = r.randn(rows, hdim).astype(np.float32)
    w = (1 + 0.2 * r.randn(hdim)).astype(np.float32)
    b = (0.1 * r.randn(hdim)).astype(np.float32)
    dy = r.randn(rows, hdim).astype(np.float32)
    dh2 = r.randn(rows, hdim).astype(np.float32)
    return x, res, w, b, dy, dh2


def _jax_vjp(args, dy, dh2, dtype, **kw):
    f = lambda x, res, w, b: jax_fused.fused_dropout_add_layernorm(  # noqa: E731
        x, res, w, b, block_rows=16, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in args))
    grads = vjp((jnp.asarray(dy, dtype), jnp.asarray(dh2, dtype)))
    return [np.asarray(t.astype(jnp.float32)) for t in (*out, *grads)]


def _port_vjp(args, dy, dh2, dtype, **kw):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    y, h = fused.fused_dropout_add_layernorm(*ts, **kw)
    assert y.dtype == h.dtype == dtype
    torch.autograd.backward((y, h), (torch.from_numpy(dy).to(dtype),
                                     torch.from_numpy(dh2).to(dtype)))
    return [t.detach().float().numpy() for t in (y, h, *(a.grad for a in ts))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,training", [(0.1, True), (0.0, True),
                                        (0.1, False)])
@pytest.mark.parametrize("rows", [48, 45])
def test_fused_op_matches_jax(dtype, p, training, rows):
    """The autograd op (plain forward and backward on the CPU) against the
    Pallas kernels' custom VJP: an odd row count (the JAX side pads it to
    its 16-row blocks) and a non-zero cotangent of h."""
    x, res, w, b, dy, dh2 = _inputs(rows, 96, seed=rows)
    k, kd = _key(5)
    kw = dict(p=p, training=training, epsilon=1e-5)
    want = _jax_vjp((x, res, w, b), dy, dh2, getattr(jnp, dtype), rng=k,
                    **kw)
    got = _port_vjp((x, res, w, b), dy, dh2, getattr(torch, dtype), rng=kd,
                    **kw)
    tol = F32 if dtype == "float32" else BF16
    for name, g, wv in zip(("y", "h", "dx", "dres", "dw", "db"), got, want):
        if dtype == "bfloat16" and name not in ("y", "h"):
            scale = np.abs(wv).max()
            assert np.abs(g - wv).max() <= 2.0 ** -7 * scale, name
        else:
            np.testing.assert_allclose(g, wv, err_msg=name, **tol)


@pytest.mark.parametrize("p,training", [(0.1, True), (0.0, True)])
def test_plain_versions_match_the_pallas_kernels(p, training):
    """``dal_forward_plain`` / ``dal_backward_plain`` against
    ``_dal_call_fwd`` / ``_dal_call_bwd`` on one seed: y, h, the
    statistics, dx, dres, dw, db."""
    x, res, w, b, dy, dh2 = _inputs(32, 64, seed=11)
    seed = 987654321
    jseed = jnp.asarray([seed], jnp.int32)
    j = [jnp.asarray(a) for a in (x, res, w, b)]
    y, h, mu, rs = jax_fused._dal_call_fwd(jseed, *j, p, 1e-5, training, 16,
                                           True)
    dx, dres, dw, db = jax_fused._dal_call_bwd(
        jseed, j[0], j[1], j[2], h, mu, rs, jnp.asarray(dy), jnp.asarray(dh2),
        p, 1e-5, training, 16, True)
    t = [torch.from_numpy(a) for a in (x, res, w, b)]
    got_f = fused.dal_forward_plain(*t, seed, p=p, epsilon=1e-5,
                                    training=training)
    for g, wv in zip(got_f, (y, h, np.asarray(mu)[:, 0],
                             np.asarray(rs)[:, 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **F32)
    got_b = fused.dal_backward_plain(
        torch.from_numpy(np.array(h)), got_f[2], got_f[3], t[2],
        torch.from_numpy(dy), torch.from_numpy(dh2), seed, p=p,
        training=training)
    for g, wv in zip(got_b, (dx, dres, np.asarray(dw)[0],
                             np.asarray(db)[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-4)


def test_mask_is_the_jax_mask_and_h_is_unused():
    """With x = 1 and residual = 0, h is the scaled keep mask: the port's
    zeros sit where JAX's do; with h unused, its cotangent stays None and
    the gradients are those of y alone."""
    rows, hdim = 40, 128
    k, kd = _key(21)
    ones = np.ones((rows, hdim), np.float32)
    zeros = np.zeros((rows, hdim), np.float32)
    w, b = np.ones(hdim, np.float32), np.zeros(hdim, np.float32)
    _, hj = jax_fused.fused_dropout_add_layernorm(
        *(jnp.asarray(a) for a in (ones, zeros, w, b)), p=0.25, rng=k)
    _, ht = fused.fused_dropout_add_layernorm(
        *(torch.from_numpy(a) for a in (ones, zeros, w, b)), p=0.25, rng=kd)
    assert np.array_equal(ht.numpy() == 0, np.asarray(hj) == 0)
    assert 0.2 < float((ht == 0).float().mean()) < 0.3
    x, res, w, b, dy, _ = _inputs(rows, hdim, seed=3)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, res, w, b)]
    y, _ = fused.fused_dropout_add_layernorm(*ts, p=0.25, rng=kd)
    y.backward(torch.from_numpy(dy))
    want = _jax_vjp((x, res, w, b), dy, np.zeros_like(dy), jnp.float32,
                    p=0.25, rng=k)
    for a, wv in zip(ts, want[2:]):
        np.testing.assert_allclose(a.grad.numpy(), wv, **F32)


def test_cpu_tensors_launch_no_kernel_and_bad_args_raise():
    before = (fused.dal_forward.launches, fused.dal_backward.launches)
    x, res, w, b, dy, _ = _inputs(8, 32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, res, w, b)]
    y, _ = fused.fused_dropout_add_layernorm(*ts, p=0.1, rng=_key(0)[1])
    y.backward(torch.from_numpy(dy))
    assert (fused.dal_forward.launches, fused.dal_backward.launches) == before
    with pytest.raises(ValueError):
        fused.fused_dropout_add_layernorm(ts[0], ts[1][:4], ts[2], ts[3],
                                          training=False)
    with pytest.raises(ValueError):
        fused.fused_dropout_add_layernorm(*ts, p=1.0, rng=_key(0)[1])
    with pytest.raises(ValueError):
        fused.fused_dropout_add_layernorm(*ts, training=False, block_rows=0)
