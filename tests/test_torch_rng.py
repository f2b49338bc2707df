"""The port's key tracker (``core/rng.py``) and dropout under it, against
the JAX package: bit for bit.

Keys: the tracker's draws after ``seed``, named streams, ``rng_state``,
``model_parallel_rng(base, 0, 1)``, ``states`` / ``set_states`` and the
``key_scope`` derivations are JAX's key data; the train step given no key
refuses a default draw as the jitted JAX step does, and given one serves
draws from its scope.  Dropout: ``F.dropout`` (and ``nn.Dropout``) with a
key and without one (the tracker's), masks and outputs in bfloat16 and
float32 at p 0.1 and 0.5, the gradient (the same mask on ``dy``), and
dense attention's probability dropout: all equal to JAX's, bit for bit.
The dropout wrapper on CPU tensors is the plain version and counts no
launch."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
import paddle_ray_tpu_torch as ptt
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.core import rng as jrng
from paddle_ray_tpu.core.module import Module
from paddle_ray_tpu.nn import Dropout as JaxDropout
from paddle_ray_tpu.nn import functional as JF
from paddle_ray_tpu.ops import fused as jax_fused
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch.core import prng
from paddle_ray_tpu_torch.core import rng as trng
from paddle_ray_tpu_torch.nn import Dropout
from paddle_ray_tpu_torch.nn import functional as F
from paddle_ray_tpu_torch.ops import fused
from paddle_ray_tpu_torch.optimizer import AdamW
from paddle_ray_tpu_torch.parallel import build_train_step

D = importlib.import_module("paddle_ray_tpu_torch.ops.dropout")


def _data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), _data(want))


@pytest.fixture(autouse=True)
def fresh_trackers():
    """Both trackers reseeded to 0 after each test (other tests draw from
    the JAX one)."""
    yield
    prt.seed(0)
    ptt.seed(0)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5, -3])
def test_draws_after_seed(seed):
    prt.seed(seed)
    ptt.seed(seed)
    for _ in range(4):
        got = trng.next_key()
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        assert _same(got, jrng.next_key())


def test_named_streams_and_rng_state():
    prt.seed(3)
    ptt.seed(3)
    jt, tt = jrng.get_rng_state_tracker(), trng.get_rng_state_tracker()
    jt.add("extra", 11)
    tt.add("extra", 11)
    assert _same(tt.next("extra"), jt.next("extra"))
    assert _same(trng.next_key(), jrng.next_key())
    with jt.rng_state("extra"), tt.rng_state("extra"):
        assert tt.current == jt.current == "extra"
        assert _same(trng.next_key(), jrng.next_key())
    assert tt.current == trng.GLOBAL_RNG
    assert _same(trng.next_key("extra"), jrng.next_key("extra"))
    with pytest.raises(KeyError):
        tt.next("missing")


@pytest.mark.parametrize("base", [0, 1234])
def test_model_parallel_rng(base):
    jrng.model_parallel_rng(base, 0, 1)
    trng.model_parallel_rng(base, 0, 1)
    for name in (trng.GLOBAL_RNG, trng.LOCAL_RNG, trng.GLOBAL_RNG):
        assert _same(trng.next_key(name), jrng.next_key(name))
    jt, tt = jrng.get_rng_state_tracker(), trng.get_rng_state_tracker()
    with jt.rng_state(jrng.LOCAL_RNG), tt.rng_state(trng.LOCAL_RNG):
        assert _same(trng.next_key(), jrng.next_key())


def test_states_and_set_states_restore():
    prt.seed(5)
    ptt.seed(5)
    jt, tt = jrng.get_rng_state_tracker(), trng.get_rng_state_tracker()
    jt.add("side", 9)
    tt.add("side", 9)
    trng.next_key()
    jrng.next_key()
    js, ts = jt.states(), tt.states()
    assert sorted(ts) == sorted(js) == ["global_seed", "side"]
    for name in ts:
        assert _same(ts[name], js[name])
    want = [_data(jrng.next_key()) for _ in range(3)]
    got = [trng.next_key().numpy() for _ in range(3)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # restoring replays the same draws; a stream added since is dropped
    tt.add("later", 1)
    tt.set_states(ts)
    assert sorted(tt.states()) == ["global_seed", "side"]
    again = [trng.next_key().numpy() for _ in range(3)]
    assert all(np.array_equal(g, w) for g, w in zip(again, want))


@pytest.mark.parametrize("seed", [0, 77])
def test_key_scope_derivations(seed):
    k, kd = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    prt.seed(1)
    ptt.seed(1)
    jt, tt = jrng.get_rng_state_tracker(), trng.get_rng_state_tracker()
    jt.add(jrng.LOCAL_RNG, 2)
    tt.add(trng.LOCAL_RNG, 2)
    with jrng.key_scope(k), trng.key_scope(kd):
        pairs = [(trng.next_key(), jrng.next_key()) for _ in range(3)]
        pairs.append((trng.next_key(trng.LOCAL_RNG),
                      jrng.next_key(jrng.LOCAL_RNG)))
        with jt.rng_state(jrng.LOCAL_RNG), tt.rng_state(trng.LOCAL_RNG):
            pairs.append((trng.next_key(), jrng.next_key()))
        with jrng.key_scope(jax.random.fold_in(k, 1)), \
                trng.key_scope(prng.fold_in(kd, 1)):
            pairs.append((trng.next_key(), jrng.next_key()))
        pairs.append((trng.next_key(), jrng.next_key()))
    for got, want in pairs:
        assert _same(got, want)
    # the scope left the global stream where it was
    assert _same(trng.next_key(), jrng.next_key())


def _draws_loss(seen):
    def loss_fn(model, batch, rng):
        seen.append(trng.next_key())
        return (model(batch) ** 2).mean()
    return loss_fn


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


class _JaxLinear(Module):
    def __init__(self):
        self.w = jnp.ones((3, 2))

    def forward(self, x):
        return x @ self.w


def test_step_without_key_refuses_default_draws(one_device_topology):
    """The JAX step traced without a key raises ``RuntimeError`` on a
    default draw; so does the port's, leaving the stream as it was."""
    def jax_loss(m, batch, rng):
        jrng.next_key()
        return (m(batch) ** 2).mean()

    jts = jax_build_train_step(_JaxLinear(), jax_optim.AdamW(1e-3),
                               jax_loss, topo=one_device_topology,
                               donate=False)
    with pytest.raises(RuntimeError, match="rng"):
        jts.step(jnp.ones((4, 3)))

    ptt.seed(8)
    seen = []
    lin = torch.nn.Linear(3, 2)
    ts = build_train_step(lin, AdamW(1e-3), _draws_loss(seen))
    with pytest.raises(RuntimeError, match="rng"):
        ts.step(torch.ones(4, 3))
    prt.seed(8)
    assert _same(trng.next_key(), jrng.next_key())
    # eager draws outside a step advance the stream as JAX's do
    assert _same(trng.next_key(), jrng.next_key())


def test_step_with_key_serves_draws_from_its_scope():
    kd = prng.PRNGKey(21)
    seen = []
    ts = build_train_step(torch.nn.Linear(3, 2), AdamW(1e-3),
                          _draws_loss(seen))
    ts.step(torch.ones(4, 3), kd)
    with jrng.key_scope(jax.random.PRNGKey(21)):
        assert _same(seen[0], jrng.next_key())
    # the tracker itself refuses a draw inside the step, key or not

    def tracker_draw(model, batch, rng):
        trng.get_rng_state_tracker().next()
        return model(batch).sum()
    with pytest.raises(RuntimeError, match="rng"):
        build_train_step(torch.nn.Linear(3, 2), AdamW(1e-3),
                         tracker_draw).step(torch.ones(4, 3), kd)
    # grad accumulation: micro-batch i under split(key, 2)[i]
    seen.clear()
    ts = build_train_step(torch.nn.Linear(3, 2), AdamW(1e-3),
                          _draws_loss(seen), grad_accum=2)
    ts.step(torch.ones(4, 3), kd)
    for got, sub in zip(seen, jax.random.split(jax.random.PRNGKey(21), 2)):
        with jrng.key_scope(sub):
            assert _same(got, jrng.next_key())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_mask_and_output_bit_exact(dtype, p, mode):
    r = np.random.RandomState(1)
    x = r.randn(4, 33, 65).astype(np.float32)
    k, kd = jax.random.PRNGKey(9), prng.PRNGKey(9)
    want = JF.dropout(jnp.asarray(x, dtype), p, training=True, rng=k,
                      mode=mode)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = F.dropout(xt, p, training=True, rng=kd, mode=mode)
    assert got.dtype == xt.dtype
    want = np.asarray(want.astype(jnp.float32))
    mask = np.asarray(jax.random.bernoulli(k, 1.0 - p, x.shape))
    assert np.array_equal(got.float().numpy() != 0, mask & (x != 0))
    np.testing.assert_array_equal(got.float().numpy(), want)
    plain = D.dropout_plain(xt, kd, p, upscale=mode == "upscale_in_train")
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_gradient_is_the_jax_vjp(dtype):
    r = np.random.RandomState(2)
    x = r.randn(6, 40).astype(np.float32)
    dy = r.randn(6, 40).astype(np.float32)
    k, kd = jax.random.PRNGKey(4), prng.PRNGKey(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda t: JF.dropout(t, 0.1, rng=k),
                     jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(dy, jdt))[0].astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    F.dropout(xt, 0.1, rng=kd).backward(torch.from_numpy(dy).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(), want)


def test_dropout_without_a_key_draws_from_the_tracker():
    r = np.random.RandomState(3)
    x = r.randn(5, 70).astype(np.float32)
    prt.seed(17)
    ptt.seed(17)
    want = [np.asarray(JF.dropout(jnp.asarray(x), 0.2)),
            np.asarray(JaxDropout(0.2)(jnp.asarray(x)))]
    got = [F.dropout(torch.from_numpy(x), 0.2).numpy(),
           Dropout(0.2)(torch.from_numpy(x)).numpy()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _same(trng.next_key(), jrng.next_key())


def test_fused_dropout_add_layernorm_without_a_key_draws_from_the_tracker():
    r = np.random.RandomState(4)
    x, res = (torch.from_numpy(r.randn(6, 32).astype(np.float32))
              for _ in range(2))
    w, b = torch.ones(32), torch.zeros(32)
    ptt.seed(5)
    got = fused.fused_dropout_add_layernorm(x, res, w, b, p=0.25)
    ptt.seed(5)
    key = trng.next_key()
    want = fused.fused_dropout_add_layernorm(x, res, w, b, p=0.25, rng=key)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    prt.seed(5)
    jy, jh = jax_fused.fused_dropout_add_layernorm(
        jnp.asarray(x.numpy()), jnp.asarray(res.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), p=0.25)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)


def test_attention_probability_dropout_matches_jax():
    r = np.random.RandomState(5)
    q, k, v = (r.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    key, kd = jax.random.PRNGKey(6), prng.PRNGKey(6)
    want = JF.scaled_dot_product_attention(
        *(jnp.asarray(t) for t in (q, k, v)), causal=True, dropout_p=0.3,
        rng=key, training=True)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True,
        dropout_p=0.3, rng=kd, training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the probabilities' zeros are the mask's
    plain = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True)
    assert not torch.equal(got, plain)
    off = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True,
        dropout_p=0.3, rng=kd, training=False)
    assert torch.equal(off, plain)


def test_cpu_dropout_launches_no_kernel_and_checks_p():
    x = torch.randn(3, 8)
    before = D.threefry_dropout.launches
    y = D.threefry_dropout(x, prng.PRNGKey(1), 0.5)
    assert D.threefry_dropout.launches == before
    assert torch.equal(y, D.dropout_plain(x, prng.PRNGKey(1), 0.5))
    assert torch.equal(D.threefry_dropout(x, (0, 1), 1.0),
                       torch.zeros_like(x))
    with pytest.raises(ValueError):
        D.threefry_dropout(x, prng.PRNGKey(1), 1.5)
    with pytest.raises(ValueError):
        D.threefry_dropout(x.to("meta"), prng.PRNGKey(1), 0.5)
