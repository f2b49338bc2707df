"""The port's dynamic PTQ and QAT against the JAX package.

Bit for bit (``assert_array_equal``): ``quantize_per_tensor``,
``dequantize``, ``fake_quant`` and its straight-through gradient, and
``QuantizedLinear`` -- built by ``from_linear`` from the same float
weights -- per channel and per tensor, on 2-D and 3-D float32 and
bfloat16 inputs, with and without bias (its product is the plain version
of the int8 kernel here, exact in float64, then JAX's ``acc * (s_x *
s_w)``).  ``quantize_model`` replaces the same layers as JAX in a fused
encoder stack and in BERT.  Tolerances, with their reasons:

- the quantized encoder stack, against the JAX layers run eagerly as the
  JAX package's tests run them, is checked layer by layer: every
  ``QuantizedLinear`` is hooked on both sides.  Its first layer's qkv
  sees the same input on both sides, but every later int8 input is an
  output of flash attention, LayerNorm or GELU, which JAX and PyTorch sum
  in other orders (float32 differences near 1e-7).  An activation that
  lands within that difference of a rounding midpoint can take the
  neighbouring int8 step on one side: one code of the pre-LN stack's
  first ``linear2`` input sits on a midpoint and takes it on x86 builds of
  both libraries, and the step then spreads through every later layer
  (more codes flip, per-tensor scales move).  So each
  layer's input must differ from JAX's by float32 rounding alone (64
  ulps of its largest value) up to and including the first layer whose
  codes flip, which holds flash attention, LayerNorm, GELU and the
  residuals that far; each layer must give the JAX layer's output bit for
  bit on its own input;
  its codes and scale, when they agree with the JAX run's, must give the
  JAX run's output bit for bit; and a code that differs must differ by
  one step, from a JAX value no further from a midpoint than the layer's
  measured input difference allows (twice it, over the scale: the scale
  moves with the largest activation, by at most that difference / 127).
  The post-LN stack, which flips no code, is also held whole:
  ``max|err| / max|ref|`` 1e-3.
- the QAT loss curve: ``rtol`` 1e-4 over 30 Adam(5e-2) steps (the same
  summation-order differences, through fake-quant rounding that a step
  can flip for a value at a midpoint).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu import nn as jnn
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu import quantization as JQ
from paddle_ray_tpu.core.rng import key_scope
from paddle_ray_tpu.incubate import nn as jinc
from paddle_ray_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_ray_tpu.models.bert import BertForPretraining as JaxBert
from paddle_ray_tpu.nn import functional as JF
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch import quantization as Q
from paddle_ray_tpu_torch.incubate import nn as tinc
from paddle_ray_tpu_torch.models import BertConfig, BertForPretraining
from paddle_ray_tpu_torch.nn import functional as F
from paddle_ray_tpu_torch.nn.layers import Linear
from paddle_ray_tpu_torch.ops.fused import int8_matmul
from paddle_ray_tpu_torch.optimizer import Adam
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (incubate_from_jax_state_dict,
                                          quantized_from_jax_state_dict,
                                          quantized_to_jax_state_dict)

E, HEADS, FFN, B, S = 64, 4, 128, 2, 32
LENGTHS = (32, 21)
STACK_TOL = 1e-3
QAT_RTOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


def _jnp(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dequantize_fake_quant_bit_exact(dtype, bits):
    r = np.random.RandomState(bits)
    x = (r.randn(7, 33) * 3).astype(np.float32)
    jx = _jnp(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JQ.quantize_per_tensor(jx, bits)
    tq, ts = Q.quantize_per_tensor(tx, bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_np(Q.dequantize(tq, ts)),
                                  np.asarray(JQ.dequantize(jq, js)))
    np.testing.assert_array_equal(_np(Q.fake_quant(tx, bits)),
                                  np.asarray(JQ.fake_quant(jx, bits)))


def test_fake_quant_gradient_is_straight_through():
    r = np.random.RandomState(1)
    x, c = r.randn(5, 9).astype(np.float32), r.randn(5, 9).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(JQ.fake_quant(v) * c))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (Q.fake_quant(tx) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), c)


def _linear_pair(seed, n_in, n_out, bias):
    r = np.random.RandomState(seed)
    w = (r.randn(n_in, n_out) / np.sqrt(n_in)).astype(np.float32)
    b = (0.1 * r.randn(n_out)).astype(np.float32)
    prt.seed(seed)
    jl = jnn.Linear(n_in, n_out, bias=bias)
    tl = Linear(n_in, n_out, bias=bias, device="cpu")
    jl.load_state_dict({"weight": w, **({"bias": b} if bias else {})})
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        if bias:
            tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantized_linear_matches_jax_bit_for_bit(per_channel, dtype, bias):
    jl, tl = _linear_pair(11, 48, 40, bias)
    jq = JQ.QuantizedLinear.from_linear(jl, per_channel)
    tq = Q.QuantizedLinear.from_linear(tl, per_channel)
    np.testing.assert_array_equal(tq.weight_q.numpy(), np.asarray(jq.weight_q))
    np.testing.assert_array_equal(tq.weight_scale.numpy(),
                                  np.asarray(jq.weight_scale))
    r = np.random.RandomState(2)
    for shape in ((13, 48), (2, 5, 48)):
        x = (2 * r.randn(*shape)).astype(np.float32)
        want = jq(_jnp(x, dtype))
        got = tq(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == shape[:-1] + (40,)
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_is_one_fused_product(dtype, bias, monkeypatch):
    """The layer's product is one ``int8_mm`` call on the K-major copy, with
    no x scale, the bias added inside and x's dtype written -- here a
    bfloat16 layer's bfloat16 bias too -- and gives the JAX layer's output
    bit for bit, leading dims flattened."""
    jl, tl = _linear_pair(13, 64, 24, bias)
    if dtype == "bfloat16":
        tl.to(torch.bfloat16)
        jl.load_state_dict({k: np.asarray(jnp.asarray(v).astype(
            jnp.bfloat16)) for k, v in jl.state_dict().items()})
    jq = JQ.QuantizedLinear.from_linear(jl)
    tq = Q.QuantizedLinear.from_linear(tl)
    assert tq.weight_qT.shape == (24, 64) and tq.weight_qT.is_contiguous()
    assert torch.equal(tq.weight_qT, tq.weight_q.t())
    calls = []
    real = Q.quant.int8_mm

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(Q.quant, "int8_mm", spy)
    x = (2 * np.random.RandomState(6).randn(3, 7, 64)).astype(np.float32)
    want = jq(_jnp(x, dtype))
    got = tq(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert len(calls) == 1
    (xq, w, x_scale, _, out_dtype), kw = calls[0]
    assert w is tq.weight_qT and x_scale is None and kw["k_major"]
    assert kw["bias"] is tq.bias and out_dtype == getattr(torch, dtype)
    assert xq.shape == (21, 64)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 7, 24)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want.astype(jnp.float32)))


def test_k_major_copy_stays_out_of_the_state_and_follows_loads():
    """``weight_qT`` is a non-persistent buffer: no state-dict key, and the
    next call makes it again after a state is loaded, after any other
    in-place write to ``weight_q``, and after ``weight_q`` is replaced --
    each call then gives a freshly built layer's output."""
    _, tl = _linear_pair(14, 16, 8, True)
    tq = Q.QuantizedLinear.from_linear(tl)
    assert sorted(tq.state_dict()) == ["bias", "weight_q", "weight_scale"]
    x = torch.from_numpy(np.random.RandomState(7).randn(5, 16)
                         .astype(np.float32))
    other = Q.QuantizedLinear.from_linear(_linear_pair(15, 16, 8, True)[1])
    tq.load_state_dict(other.state_dict())
    assert torch.equal(tq.weight_q, other.weight_q)
    assert torch.equal(tq(x), other(x))
    assert torch.equal(tq.weight_qT, other.weight_q.t())
    with torch.no_grad():
        tq.weight_q.neg_()
    flipped = Q.QuantizedLinear(-other.weight_q, other.weight_scale,
                                other.bias)
    assert torch.equal(tq(x), flipped(x))
    assert torch.equal(tq.weight_qT, tq.weight_q.t())
    tq.weight_q = other.weight_q.clone()
    assert torch.equal(tq(x), other(x))
    assert torch.equal(tq.weight_qT, other.weight_q.t())


def _encoder_pair(normalize_before, n_layers=2):
    """Fused encoder layers on each side with one numpy state (the JAX
    layers built from their abstract shapes: no eager random init)."""
    jms, tms, states = [], [], []
    r = np.random.RandomState(5 + int(normalize_before))
    kw = dict(dropout_rate=0.1, activation="gelu", attn_dropout_rate=0.0,
              normalize_before=normalize_before)

    def build(key):
        with key_scope(key):
            return jinc.FusedTransformerEncoderLayer(E, HEADS, FFN, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # attn_dropout_rate's warning
        shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
        for _ in range(n_layers):
            jm = jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, a.dtype), shapes)
            tm = tinc.FusedTransformerEncoderLayer(E, HEADS, FFN, **kw,
                                                   device="cpu")
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
            jms.append(jm.eval())
            tms.append(tm.eval())
            states.append(state)
    return jms, torch.nn.ModuleList(tms), states


def _stack_inputs():
    r = np.random.RandomState(9)
    x = r.randn(B, S, E).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None])
    return x, mask[:, None, None, :]


def _hook_quantized_linears(modules, register, is_quantized, to_np):
    """Hook every quantized linear of ``modules`` (in call order the
    records fill): each call appends ``(layer, input, output)``, numpy
    float32."""
    calls, handles = [], []

    def hook(layer, args, out):
        calls.append((layer, to_np(args[0]), to_np(out)))
    for m in modules:
        for sub in m:
            if is_quantized(sub):
                handles.append(register(sub, hook))
    return calls, handles


# the slack, in int8 steps, of a midpoint test: x / scale rounded to
# float32 on each side, and the two scales' own roundings
MIDPOINT_SLACK = 2.0 ** -14
# the input difference, over the input's largest value, of a layer that
# only summation order separates from JAX's: float32 rounding (64 ulps)
ROUNDING_DX = 64 * 2.0 ** -23


def _check_layer(i, jl, xj, yj, xt, yt, rounding_only):
    """One hooked layer: the JAX layer on the port's input gives the port's
    output bit for bit; every code that differs from the JAX run's is one
    step from a JAX value within the input difference of a midpoint; with
    no such code (and the same scale) the outputs are bit-equal.  With
    ``rounding_only`` the inputs must besides differ by no more than
    float32 rounding (``ROUNDING_DX`` of the largest).  Returns the number
    of codes that differ."""
    mine = np.asarray(jl.forward(jnp.asarray(xt)).astype(jnp.float32))
    np.testing.assert_array_equal(yt, mine, err_msg=f"linear {i}")
    qj, sj = (np.asarray(a) for a in JQ.quantize_per_tensor(jnp.asarray(xj)))
    qt, st = (a.numpy() for a in Q.quantize_per_tensor(torch.from_numpy(xt)))
    dx = float(np.abs(xt - xj).max())
    if rounding_only:
        assert dx <= ROUNDING_DX * float(np.abs(xj).max()), (i, dx)
    flips = qt != qj
    if not flips.any() and sj == st:
        np.testing.assert_array_equal(yt, yj, err_msg=f"linear {i}")
    if flips.any():
        assert np.abs(qt.astype(np.int32) - qj)[flips].max() == 1, i
        u = (xj[flips] / sj).astype(np.float32)
        from_mid = np.abs(u - np.floor(u) - 0.5)
        reach = 2 * dx / min(float(sj), float(st)) + MIDPOINT_SLACK
        assert from_mid.max() <= reach, (i, from_mid.max(), reach)
    return int(flips.sum())


@pytest.mark.parametrize("normalize_before", [False, True])
def test_quantize_model_on_an_encoder_stack_matches_jax(normalize_before):
    jms, tms, _ = _encoder_pair(normalize_before)
    x, mask = _stack_inputs()
    jms = [JQ.quantize_model(m) for m in jms]
    tms = Q.quantize_model(tms)
    want_names = {f"{i}.{p}" for i, m in enumerate(jms)
                  for p, sub in m.modules()
                  if isinstance(sub, JQ.QuantizedLinear)}
    got_names = {p for p, sub in tms.named_modules()
                 if isinstance(sub, Q.QuantizedLinear)}
    assert got_names == want_names
    assert len(got_names) == 8           # qkv, out_proj, linear1, linear2
    jcalls, jhooks = _hook_quantized_linears(
        [[sub for _, sub in m.modules()] for m in jms],
        lambda sub, hook: sub.register_forward_post_hook(hook),
        lambda sub: isinstance(sub, JQ.QuantizedLinear),
        lambda a: np.asarray(a.astype(jnp.float32)))
    tcalls, thooks = _hook_quantized_linears(
        [tms.modules()], lambda sub, hook: sub.register_forward_hook(hook),
        lambda sub: isinstance(sub, Q.QuantizedLinear),
        lambda t: t.detach().float().numpy())
    h = jnp.asarray(x)
    for m in jms:
        h = m(h, jnp.asarray(mask))
    want = np.asarray(h)
    before = int8_matmul.launches
    with torch.no_grad():
        t = torch.from_numpy(x)
        for m in tms:
            t = m(t, torch.from_numpy(mask))
    assert int8_matmul.launches == before
    for hk in jhooks + thooks:
        hk.remove()
    got = t.numpy()
    assert np.isfinite(got).all()
    assert len(jcalls) == len(tcalls) == 8
    # up to and including the first layer whose codes flip, the inputs
    # differ by summation order alone; after it, by that flip's spread
    rounding_only = True
    for i, ((jl, xj, yj), (tl, xt, yt)) in enumerate(zip(jcalls, tcalls)):
        np.testing.assert_array_equal(tl.weight_q.numpy(),
                                      np.asarray(jl.weight_q))
        if _check_layer(i, jl, xj, yj, xt, yt, rounding_only):
            rounding_only = False
    if not normalize_before:
        assert np.abs(got - want).max() <= STACK_TOL * np.abs(want).max()


def test_quantize_model_on_bert_replaces_what_jax_replaces():
    """Only the head's plain Linears are quantized: the blocks'
    Column/RowParallelLinear are not Linear on either side."""
    tiny = dict(vocab_size=128, max_seq_len=16, hidden_size=32,
                num_layers=2, num_heads=4)

    def build(key):
        with key_scope(key):
            return JaxBert(JaxBertConfig(**tiny))
    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
    jm = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    jm = JQ.quantize_model(jm)
    want = {p for p, m in jm.modules() if isinstance(m, JQ.QuantizedLinear)}
    g = torch.Generator()
    g.manual_seed(0)
    tm = Q.quantize_model(BertForPretraining(BertConfig(**tiny),
                                             device="cpu", generator=g))
    got = {p for p, m in tm.named_modules()
           if isinstance(m, Q.QuantizedLinear)}
    assert got == want == {"bert.pooler", "mlm_transform", "nsp"}
    ids = torch.arange(16).reshape(2, 8)
    with torch.no_grad():
        out = tm(ids)
    assert all(torch.isfinite(o).all() for o in out)


def test_ptq_config_surface():
    """Mirrors the JAX package's own surface test: PTQ(QuantConfig)
    quantize + convert gives int8 layers within int8 error of the float
    net, and the same bits as JAX's PTQ; the quanter registry's factory
    and its two refusals."""
    jl1, tl1 = _linear_pair(3, 4, 8, True)
    jl2, tl2 = _linear_pair(4, 8, 2, True)
    jnet = jnn.Sequential(jl1, jnn.ReLU(), jl2)
    tnet = torch.nn.Sequential(tl1, torch.nn.ReLU(), tl2)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    with torch.no_grad():
        base = tnet(torch.from_numpy(x)).numpy()
    cfg = Q.QuantConfig(activation=None, weight=None)
    cfg.add_type_config(Linear)
    cfg.add_layer_config(tl1)
    q = Q.PTQ(cfg).quantize(tnet, inplace=True)
    q = Q.PTQ(cfg).convert(q)
    assert isinstance(q[0], Q.QuantizedLinear)
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, base, rtol=0.2, atol=0.2)
    jcfg = JQ.QuantConfig()
    want = np.asarray(JQ.PTQ(jcfg).convert(JQ.PTQ(jcfg).quantize(jnet))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)

    @Q.quanter("PortQuanter")
    class PortQuanterLayer(Q.BaseQuanter):
        def forward(self, x):
            return x

    inst = PortQuanter()._instance()          # noqa: F821 -- injected
    assert isinstance(inst, Q.BaseQuanter)
    assert PortQuanterLayer._factory is PortQuanter   # noqa: F821
    with pytest.raises(ValueError, match="differ from the class name"):
        @Q.quanter("Shadowed")
        class Shadowed(Q.BaseQuanter):
            pass
    with pytest.raises(ValueError, match="already bound"):
        @Q.quanter("pytest")
        class Other(Q.BaseQuanter):
            pass
    with pytest.raises(NotImplementedError):
        Q.BaseObserver().cal_thresholds()


@pytest.fixture
def one_device_topology():
    saved = current_topology()
    topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    try:
        yield topo
    finally:
        set_topology(saved)


def test_qat_train_then_convert_matches_jax(one_device_topology):
    """The JAX package's QAT round trip, on both sides from the same
    weights: 30 Adam(5e-2) steps through fake-quant, then ``convert``."""
    jl1, tl1 = _linear_pair(7, 8, 16, True)
    jl2, tl2 = _linear_pair(8, 16, 4, True)
    jnet = JQ.QAT().quantize(jnn.Sequential(jl1, jnn.ReLU(), jl2))
    qat = Q.QAT()
    tnet = qat.quantize(torch.nn.Sequential(tl1, torch.nn.ReLU(), tl2))
    assert isinstance(tnet[0], Q.QATLinear) and tnet[0].weight is tl1.weight
    r = np.random.RandomState(0)
    x8 = r.randn(64, 8).astype(np.float32)
    y8 = r.randint(0, 4, 64)

    def jloss(m, b, rng):
        return JF.cross_entropy(m(b[0]), b[1])
    jts = jax_build_train_step(jnet, jax_optim.Adam(5e-2), jloss,
                               topo=one_device_topology, donate=False)
    want = [float(jts.step((jnp.asarray(x8), jnp.asarray(y8))))
            for _ in range(30)]

    def tloss(m, b, rng):
        return F.cross_entropy(m(b[0]), b[1])
    ts = build_train_step(tnet, Adam(5e-2), tloss)
    batch = (torch.from_numpy(x8), torch.from_numpy(y8))
    got = [float(ts.step(batch)) for _ in range(30)]
    assert got[-1] < got[0] * 0.5          # trains through fake-quant
    np.testing.assert_allclose(got, want, rtol=QAT_RTOL)
    with torch.no_grad():
        fq_logits = tnet(batch[0]).numpy()
    int8_net = qat.convert(tnet)
    assert isinstance(int8_net[0], Q.QuantizedLinear)
    assert isinstance(int8_net[2], Q.QuantizedLinear)
    with torch.no_grad():
        int8_logits = int8_net(batch[0]).numpy()
    assert (int8_logits.argmax(-1) == fq_logits.argmax(-1)).mean() > 0.95


def test_qat_root_linear_and_to_linear():
    _, tl = _linear_pair(12, 4, 4, True)
    qat = Q.QAT(weight_bits=8, activation_bits=8)
    q = qat.quantize(tl)                  # the root module is the Linear
    assert isinstance(q, Q.QATLinear)
    back = q.to_linear()
    assert isinstance(back, Linear)
    assert back.weight is tl.weight and back.bias is tl.bias
    assert (back.in_features, back.out_features) == (4, 4)
    x = torch.randn(3, 4)
    torch.testing.assert_close(back(x), tl(x), rtol=0, atol=0)
    conv = qat.convert(q)
    assert isinstance(conv, Q.QuantizedLinear)
    assert conv.weight_scale.shape == (1, 4)
    assert qat.convert(Q.QAT().quantize(tl), per_channel=False
                       ).weight_scale.shape == ()


@pytest.mark.parametrize("per_channel", [True, False])
def test_weight_bridge_loads_a_jax_quantized_state(per_channel):
    jms, _, states = _encoder_pair(False, n_layers=1)
    jm = JQ.quantize_model(jms[0], per_channel=per_channel)
    state = jm.state_dict()
    assert state["fused_attn.qkv.weight_q"].dtype == np.int8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")

        def fresh():
            return tinc.FusedTransformerEncoderLayer(
                E, HEADS, FFN, dropout_rate=0.1, activation="gelu",
                attn_dropout_rate=0.0, device="cpu").eval()
        tm = quantized_from_jax_state_dict(fresh(), state)
    assert isinstance(tm.ffn.linear1, Q.QuantizedLinear)
    for sub in tm.modules():
        if isinstance(sub, Q.QuantizedLinear):
            assert "weight_qT" not in sub.state_dict()
            assert torch.equal(sub._weight_qT(), sub.weight_q.t())
    back = quantized_to_jax_state_dict(tm)
    assert sorted(back) == sorted(state)
    for k, a in state.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k
    x = 2 * np.random.RandomState(4).randn(B, S, E).astype(np.float32)
    for path in ("fused_attn.qkv", "fused_attn.out_proj", "ffn.linear1"):
        jl, tl = jm, tm
        for part in path.split("."):
            jl, tl = getattr(jl, part), getattr(tl, part)
        n_in = tl.weight_q.shape[0]
        want = np.asarray(jl(jnp.asarray(x[..., :n_in])))
        with torch.no_grad():
            got = tl(torch.from_numpy(x[..., :n_in])).numpy()
        np.testing.assert_array_equal(got, want)
    missing = {k: a for k, a in state.items() if k != "ffn.linear2.bias"}
    with pytest.raises(KeyError):
        quantized_from_jax_state_dict(fresh(), missing)
    extra = dict(state, **{"ffn.linear2.weight": states[0][
        "ffn.linear2.weight"]})
    with pytest.raises(KeyError):
        quantized_from_jax_state_dict(fresh(), extra)
    wrong = dict(state, **{"ffn.linear2.weight_q": np.zeros((3, 3),
                                                            np.int8)})
    with pytest.raises(ValueError):
        quantized_from_jax_state_dict(fresh(), wrong)
