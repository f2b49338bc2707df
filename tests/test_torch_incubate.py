"""The port's ``incubate.nn`` fused layers against the JAX package.

Each layer is built on both sides and holds one numpy state dict (random
weights; LayerNorm scales around 1), carried into the port by
``incubate_from_jax_state_dict``.  The JAX layers run their Pallas
kernels (flash attention, fused dropout-add-LayerNorm) in interpret mode
on the CPU, the port's its plain versions (CPU tensors).  Pre-LN and
post-LN, eval and training with dropout 0.1 under the same keys (so the
dropout masks are equal bit for bit: the murmur3 mask of the fused kernel
and the threefry bits of ``F.dropout``), a padding ``attn_mask``
``[B, 1, 1, S]``.  Tolerances: float32 outputs within ``rtol=1e-5,
atol=1e-5``, every gradient within ``max|err| / max|ref|`` 1e-5 (XLA and
PyTorch sum in different orders; a bias's gradient sums B * S terms); a
parameter the layer does not use (the pre-LN norm of a post-LN layer) has
a zero gradient in JAX and none here."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.incubate import nn as jnn
from paddle_ray_tpu_torch.incubate import nn as tnn
from paddle_ray_tpu_torch.weights import (incubate_from_jax_state_dict,
                                          incubate_to_jax_state_dict)

B, S, E, HEADS, FFN = 2, 64, 32, 4, 64
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = (64, 41)


def _build(kind, normalize_before, rate):
    """(JAX layer, port layer, state) for one layer kind."""
    kw = dict(normalize_before=normalize_before)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # attn_dropout_rate's warning
        if kind == "encoder":
            args = (E, HEADS, FFN)
            kw.update(dropout_rate=rate, activation="gelu",
                      attn_dropout_rate=0.0)
            jm = jnn.FusedTransformerEncoderLayer(*args, **kw)
            tm = tnn.FusedTransformerEncoderLayer(*args, **kw, device="cpu")
        elif kind == "attention":
            kw.update(dropout_rate=rate, attn_dropout_rate=0.0)
            jm = jnn.FusedMultiHeadAttention(E, HEADS, **kw)
            tm = tnn.FusedMultiHeadAttention(E, HEADS, **kw, device="cpu")
        elif kind == "ffn":
            kw.update(dropout_rate=rate, activation="relu")
            jm = jnn.FusedFeedForward(E, FFN, **kw)
            tm = tnn.FusedFeedForward(E, FFN, **kw, device="cpu")
        else:
            jm = jnn.FusedBiasDropoutResidualLayerNorm(E, dropout_rate=rate)
            tm = tnn.FusedBiasDropoutResidualLayerNorm(E, dropout_rate=rate,
                                                       device="cpu")
    r = np.random.RandomState(sum(map(ord, kind)) + int(normalize_before))
    state = {}
    for k, a in sorted(jm.state_dict().items()):
        if k.endswith(("ln_scale", "pre_ln.weight")):
            a = 1.0 + 0.2 * r.randn(*a.shape)
        elif a.ndim > 1:
            a = r.randn(*a.shape) / np.sqrt(a.shape[0])
        else:
            a = 0.1 * r.randn(*a.shape)
        state[k] = a.astype(np.float32)
    jm.load_state_dict(state)
    incubate_from_jax_state_dict(tm, state)
    return jm, tm, state


def _inputs(kind):
    r = np.random.RandomState(7)
    x = r.randn(B, S, E).astype(np.float32)
    res = r.randn(B, S, E).astype(np.float32)
    cot = r.randn(B, S, E).astype(np.float32)
    valid = np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None]
    mask = valid[:, None, None, :]
    return x, res, cot, mask


def _call(kind, m, x, res, mask, rng):
    if kind == "encoder":
        return m(x, mask, rng=rng)
    if kind == "attention":
        return m(x, attn_mask=mask, rng=rng)
    if kind == "ffn":
        return m(x, rng=rng)
    return m(x, res, rng=rng)


CASES = [(kind, nb) for kind in ("encoder", "attention", "ffn")
         for nb in (False, True)] + [("bias_dropout_residual_ln", False)]


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind,normalize_before", CASES)
def test_layer_output_and_every_grad_match_jax(kind, normalize_before,
                                               training):
    rate = 0.1
    jm, tm, _ = _build(kind, normalize_before, rate)
    if not training:
        jm.eval()
        tm.eval()
    x, res, cot, mask = _inputs(kind)
    key = jax.random.PRNGKey(123)
    kd = np.asarray(jax.random.key_data(key))

    def loss(m, x, res, mask):
        y = _call(kind, m, x, res, mask, key if training else None)
        return jnp.sum(y * jnp.asarray(cot)), y
    (_, y_j), grads_j = jax_value_and_grad(loss, has_aux=True)(
        jm, jnp.asarray(x), jnp.asarray(res), jnp.asarray(mask))
    grads_j = dict(grads_j.named_parameters())

    xt = torch.from_numpy(x).requires_grad_()
    y_t = _call(kind, tm, xt, torch.from_numpy(res), torch.from_numpy(mask),
                kd if training else None)
    (y_t * torch.from_numpy(cot)).sum().backward()
    assert y_t.shape == (B, S, E) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(grads_j)
    for name, p in tm.named_parameters():
        want = np.asarray(grads_j[name])
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy())
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(),
                                                      1.0), name


def test_training_dropout_is_applied_and_keyed():
    """With dropout, two keys give two outputs and one key one output;
    eval ignores the key; training without a key raises (the JAX global
    key tracker is not ported)."""
    _, tm, _ = _build("encoder", False, 0.1)
    x = torch.from_numpy(_inputs("encoder")[0])
    k1 = np.asarray(jax.random.key_data(jax.random.PRNGKey(1)))
    k2 = np.asarray(jax.random.key_data(jax.random.PRNGKey(2)))
    with torch.no_grad():
        a, b, c = tm(x, rng=k1), tm(x, rng=k1), tm(x, rng=k2)
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(NotImplementedError, match="core/rng.py"):
            tm(x)
        tm.eval()
        assert torch.equal(tm(x), tm(x, rng=k1))


def test_weight_bridge_round_trip_and_checks():
    for kind, nb in CASES:
        _, tm, state = _build(kind, nb, 0.1)
        back = incubate_to_jax_state_dict(tm)
        assert sorted(back) == sorted(state)
        for k, a in state.items():
            assert np.array_equal(back[k], a), (kind, k)
    missing = {k: a for k, a in state.items() if k != "bias"}
    with pytest.raises(KeyError):
        incubate_from_jax_state_dict(tm, missing)
    wrong = dict(state, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        incubate_from_jax_state_dict(tm, wrong)


def test_qkv_layout_and_constructor_checks():
    """The fused QKV columns are ``(3, heads, d)``: zeroing the q block's
    weights and bias gives uniform attention; the constructor refuses
    what the JAX one refuses and warns on attention dropout."""
    with pytest.raises(ValueError):
        tnn.FusedMultiHeadAttention(E, 5, device="cpu")
    with pytest.raises(ValueError):
        tnn.FusedMultiHeadAttention(E, HEADS, kdim=8, device="cpu")
    with pytest.raises(ValueError):
        tnn.FusedMultiHeadAttention(E, HEADS, need_weights=True,
                                    device="cpu")
    with pytest.warns(UserWarning, match="attn_dropout_rate"):
        m = tnn.FusedMultiHeadAttention(E, HEADS, dropout_rate=0.0,
                                        attn_dropout_rate=0.5, device="cpu")
    with torch.no_grad():
        m.qkv.weight[:, :E].zero_()
        m.qkv.bias.zero_()
        m.out_proj.weight.copy_(torch.eye(E))
        m.out_proj.bias.zero_()
        m.eval()
        x = torch.from_numpy(_inputs("attention")[0])
        v = x @ m.qkv.weight[:, 2 * E:]
        y = m(x)
    # post-LN of (x + mean over keys of v)
    want = torch.nn.functional.layer_norm(x + v.mean(1, keepdim=True), (E,))
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_layers_and_bert_need_a_device_without_cuda(monkeypatch):
    from paddle_ray_tpu_torch.models import BertConfig, BertForPretraining
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tnn.FusedTransformerEncoderLayer(E, HEADS, FFN)
    with pytest.raises(RuntimeError):
        BertForPretraining(BertConfig(vocab_size=64, max_seq_len=16,
                                      hidden_size=16, num_layers=1,
                                      num_heads=2))
    layer = tnn.FusedFeedForward(E, FFN, device="cpu")
    assert layer.linear1.weight.device.type == "cpu"
