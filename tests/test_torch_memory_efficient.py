"""The port's ``MemoryEfficientAdamW`` against the JAX package's, on the
CPU (where the optimizer runs the kernel's plain version).

Tolerances: ``quantize_blockwise``, ``dequantize_blockwise`` and
``stochastic_round`` bit for bit; the update fed the same gradients for 3
steps bit for bit in the parameters, the codes and the scales (a code may
differ only where its quotient lies within ``MIDPOINT_TOL`` of a rounding
midpoint, which the test checks; none has so far); the 3-step loss curve
of the JAX file's tiny GPT through ``build_train_step`` within ``rtol``
1e-5 (the JAX step is jitted, and XLA turns ``absmax / 127`` into a
product with the reciprocal, so its scales may differ in the last bit).
JAX runs the fed updates op by op, where every division is a division.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu import regularizer as jax_reg
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from paddle_ray_tpu.optimizer import memory_efficient as jme
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch import regularizer
from paddle_ray_tpu_torch.core import prng
from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.optimizer import (AdamW, MemoryEfficientAdamW,
                                            QMoment, dequantize_blockwise,
                                            quantize_blockwise,
                                            stochastic_round)
from paddle_ray_tpu_torch.optimizer.optimizer import jax_leaf_order
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          optimizer_from_jax_state,
                                          to_jax_key)

# a tiny bf16 GPT's names and shapes: vocab 97 (a last block of 97 x 32 mod
# 256 elements), position rows the batch never reaches (all-zero blocks)
SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)
# how far from a rounding midpoint (in units of the code) a quotient whose
# code differs may lie
MIDPOINT_TOL = 1e-5


def _bits(x) -> np.ndarray:
    """The bit pattern of a JAX or torch array, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint8 if x.element_size() == 1
                              else np.uint32)
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "sqrt"])
@pytest.mark.parametrize("shape", [(256,), (1000,), (3, 300), (7, 64)])
def test_quantize_and_dequantize_bit_equal_to_jax(shape, signed):
    r = np.random.RandomState(sum(shape))
    x = r.randn(*shape).astype(np.float32) * np.float32(1e-3)
    x.reshape(-1)[256:512] = 0.0            # an all-zero block where there is one
    if not signed:
        x = x * x                           # a second moment: non-negative
    qj = jme.quantize_blockwise(jnp.asarray(x), 256, signed=signed)
    qt = quantize_blockwise(torch.from_numpy(x), 256, signed=signed)
    assert qt.codes.dtype == (torch.int8 if signed else torch.uint8)
    assert tuple(qt.codes.shape) == shape
    np.testing.assert_array_equal(_bits(qt.codes), _bits(qj.codes))
    np.testing.assert_array_equal(_bits(qt.scale), _bits(qj.scale))
    dj = jme.dequantize_blockwise(qj, 256)
    dt = dequantize_blockwise(qt, 256)
    np.testing.assert_array_equal(_bits(dt), _bits(dj))


def test_stochastic_round_bit_equal_to_jax():
    r = np.random.RandomState(5)
    x = (r.randn(37, 41) * 10.0 ** r.randint(-6, 6, (37, 41))).astype(
        np.float32)
    x[0, :4] = [np.inf, -np.inf, np.nan, 0.0]
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0x5EED),
                                                3), 11)
    want = jme.stochastic_round(jnp.asarray(x), key)
    tkey = prng.fold_in(prng.fold_in(prng.PRNGKey(0x5EED), 3), 11)
    got = stochastic_round(torch.from_numpy(x), tkey)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the two words of the key work as the key
    np.testing.assert_array_equal(
        _bits(stochastic_round(torch.from_numpy(x),
                               prng.key_words(tkey))), _bits(want))


def test_leaf_index_is_the_jax_flattening_order():
    prt.seed(0)
    deep = {**SHAPE, "num_layers": 12}     # blocks 10 and 11 sort after 1
    jm = jax_build_gpt(JaxGPTConfig(**deep))
    tm = build_gpt(GPTConfig(**deep), device="cpu")
    jax_names = [n for n, _ in jm.named_parameters()]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jm)[0]]
    assert len(paths) == len(jax_names)
    names = [to_jax_key(n) for n, _ in tm.named_parameters()]
    index = jax_leaf_order(names)
    assert sorted(index) == list(range(len(names)))
    assert [names[index.index(i)] for i in range(len(names))] == jax_names


def _models(seed, dtype="bfloat16"):
    """(JAX GPT, port GPT) of ``SHAPE`` holding one random numpy state."""
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**SHAPE, dtype=dtype))
    r = np.random.RandomState(seed)
    state = {k: (0.1 * r.randn(*np.shape(a))).astype(np.float32)
             for k, a in jm.state_dict().items()}
    jm.load_state_dict(state)
    tm = gpt_from_jax_state_dict(GPTConfig(**SHAPE), state, device="cpu",
                                 dtype=getattr(torch, dtype))
    return jm, tm


def _grads(jm, seed, step):
    """Random gradients for every parameter: position rows past 32 stay
    zero (whole zero blocks), a scale per step."""
    r = np.random.RandomState(1000 * seed + step)
    out = {}
    for k, a in jm.state_dict().items():
        g = (r.randn(*np.shape(a)) * 10.0 ** r.uniform(-4, -1)).astype(
            np.float32)
        if k == "embedding.position_embeddings":
            g[32:] = 0.0
        out[k] = g
    return out


def _check_codes(name, got: QMoment, want, m_unquantized):
    """Codes and scales bit-equal; a differing code only next to a rounding
    midpoint of the quotient."""
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale),
                                  err_msg=name)
    gc, wc = got.codes.numpy(), np.asarray(want.codes)
    diff = gc != wc
    if diff.any():
        q = m_unquantized / np.maximum(np.asarray(want.scale), 1e-38)
        frac = np.abs(np.abs(q[diff]) % 1.0 - 0.5)
        assert (frac < MIDPOINT_TOL).all(), (name, frac.max())


@pytest.mark.parametrize("case", [
    dict(moment_dtype="int8"), dict(moment_dtype="bfloat16"),
    dict(moment_dtype="float32"), dict(moment_dtype="int8",
                                       master_weights=True),
    dict(moment_dtype="int8", l2=0.05), dict(moment_dtype="int8",
                                             block_size=100)],
    ids=["int8", "bf16", "f32", "int8_master", "int8_l2", "int8_block100"])
def test_fed_gradients_bit_equal_to_jax(case):
    case = dict(case)
    l2 = case.pop("l2", None)
    kw = dict(case)
    jkw, tkw = dict(kw), dict(kw)
    if l2 is not None:
        jkw["weight_decay"] = jax_reg.L2Decay(l2)
        tkw["weight_decay"] = regularizer.L2Decay(l2)
    jm, tm = _models(3)
    jopt = jme.MemoryEfficientAdamW(2e-3, **jkw)
    state = jopt.init(jm)
    topt = MemoryEfficientAdamW(2e-3, **tkw)
    topt.bind(tm.named_parameters())
    named = dict(tm.named_parameters())
    for step in range(3):
        g = _grads(jm, 3, step)
        gm = jax.tree_util.tree_map(lambda x: x, jm).load_state_dict(g)
        jm, state = jopt.step(gm, jm, state)
        for name, p in named.items():
            p.grad = torch.from_numpy(g[to_jax_key(name)]).to(p.dtype)
        topt.step()
    assert topt.step_count == int(state.step) == 3
    jp = dict(jm.named_parameters())
    names = list(jp)
    jslots = {k: dict(zip(names, jax.tree_util.tree_leaves(
        state.slots[k], is_leaf=lambda x: isinstance(x, jme.QMoment))))
        for k in ("m", "v")}
    jmaster = (dict(zip(names, jax.tree_util.tree_leaves(state.master)))
               if state.master is not None else None)
    for name, p in named.items():
        key = to_jax_key(name)
        np.testing.assert_array_equal(_bits(p), _bits(jp[key]),
                                      err_msg=name)
        st = topt.state[p]
        for slot in ("m", "v"):
            got, want = st[slot], jslots[slot][key]
            if isinstance(got, QMoment):
                # the unquantized moment is not kept: the codes' quotient
                # is recomputed from the JAX side's dequantized value
                m = np.asarray(jme.dequantize_blockwise(
                    want, topt.block_size))
                if slot == "v":
                    m = np.sqrt(m)
                _check_codes(f"{slot} of {name}", got, want, m)
            else:
                assert got.dtype == getattr(torch, case["moment_dtype"])
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"{slot} of {name}")
        if case.get("master_weights"):
            np.testing.assert_array_equal(_bits(st["master"]),
                                          _bits(jmaster[key]), err_msg=name)
        else:
            assert "master" not in st


def test_float16_refused_without_masters():
    w = torch.nn.Parameter(torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="master_weights=True"):
        MemoryEfficientAdamW(1e-3, parameters=[("w", w)])
    with pytest.raises(ValueError, match="master_weights"):
        MemoryEfficientAdamW(1e-3, multi_precision=True)
    with pytest.raises(ValueError):
        MemoryEfficientAdamW(1e-3, moment_dtype="int4")
    opt = MemoryEfficientAdamW(1e-3, master_weights=True,
                               parameters=[("w", w)])
    assert opt.state[w]["master"].dtype == torch.float32


def test_state_bytes_a_quarter_of_adamw():
    w = torch.nn.Parameter(torch.zeros(1024, 256, dtype=torch.bfloat16))
    q = MemoryEfficientAdamW(1e-3, parameters=[("w", w)]).state_nbytes()
    f = AdamW(1e-3, parameters=[("w", w)]).state_nbytes()
    assert q < f / 5 and q * 4 < f
    p = {"w": jnp.zeros((1024, 256), jnp.bfloat16)}

    def nbytes(t):
        return sum(leaf.size * leaf.dtype.itemsize
                   for leaf in jax.tree_util.tree_leaves(t)
                   if hasattr(leaf, "dtype"))
    s = jme.MemoryEfficientAdamW(1e-3).init(p)
    # the JAX state also holds its step counter (4 bytes)
    assert q == nbytes(s.slots) and f == nbytes(
        jax_optim.AdamW(1e-3).init(p)) - 4


# the JAX file's _tiny_gpt_step model (tests/test_memory_efficient.py)
TINY = dict(vocab_size=128, max_seq_len=32, hidden_size=32, num_layers=2,
            num_heads=2, dtype="float32", attn_impl="dense")


@pytest.fixture
def one_device_topology():
    saved = current_topology()
    topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    try:
        yield topo
    finally:
        set_topology(saved)


def _tiny(offload=False):
    prt.seed(0)
    jm = jax_build_gpt(JaxGPTConfig(**TINY))
    tm = gpt_from_jax_state_dict(
        GPTConfig(**{**TINY, "dtype": None}), jm.state_dict(), device="cpu")
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8, 32), 0,
                                        128))
    ts = build_train_step(tm, MemoryEfficientAdamW(1e-3), gpt_loss_fn,
                          offload_opt_state=offload)
    return jm, ts, ids


def test_tiny_gpt_loss_curve_matches_jax(one_device_topology):
    jm, ts, ids = _tiny()
    jts = jax_build_train_step(jm, jme.MemoryEfficientAdamW(1e-3),
                               jax_gpt_loss_fn, topo=one_device_topology,
                               donate=False)
    jb = (jnp.asarray(ids), jnp.asarray(ids))
    tb = (torch.tensor(ids).long(), torch.tensor(ids).long())
    want = [float(jts.step(jb)) for _ in range(3)]
    got = [float(ts.step(tb)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_offload_on_and_off_give_equal_losses():
    """On the CPU the option is accepted and changes nothing (the JAX CPU
    branch); the card's pinned-memory path is checked on the chip."""
    _, on, ids = _tiny(offload=True)
    _, off, _ = _tiny(offload=False)
    assert not on.opt.offloaded
    b = (torch.tensor(ids).long(), torch.tensor(ids).long())
    for _ in range(3):
        assert float(on.step(b)) == float(off.step(b))
    assert on.opt._copied_back is None


class _Copies:
    """Stands in for the event an offloaded step records after its copies
    of the state back to the host; counts the waits on it."""
    waits = 0

    def synchronize(self):
        _Copies.waits += 1


def test_host_reads_and_writes_of_the_state_wait_for_the_copies_back():
    """``state_dict``, ``load_state_dict`` and ``optimizer_from_jax_state``
    wait for the last step's copies back to the host before they touch the
    state (the card's race is checked on the chip)."""
    tm = build_gpt(GPTConfig(**SHAPE), device="cpu", dtype=torch.float32)
    opt = MemoryEfficientAdamW(1e-3, moment_dtype="float32")
    opt.bind(tm.named_parameters())
    slots = {k: {to_jax_key(n): np.zeros(tuple(p.shape), np.float32)
                 for n, p in tm.named_parameters()} for k in ("m", "v")}
    _Copies.waits = 0
    for touch in (opt.state_dict,
                  lambda: opt.load_state_dict(opt.state_dict()),
                  lambda: optimizer_from_jax_state(opt, 3, slots)):
        opt._copied_back = _Copies()
        touch()
        assert opt._copied_back is None
    assert _Copies.waits == 3
    assert opt.step_count == 3


def test_state_carries_from_jax_mid_curve():
    """A JAX ``MemoryEfficientAdamW`` state (int8 codes and scales, bf16
    moments) loaded into the port by ``optimizer_from_jax_state``: the next
    step equals the JAX one bit for bit."""
    for moment_dtype in ("int8", "bfloat16"):
        jm, tm = _models(4)
        jopt = jme.MemoryEfficientAdamW(2e-3, moment_dtype=moment_dtype)
        state = jopt.init(jm)
        for step in range(2):
            gm = jax.tree_util.tree_map(lambda x: x, jm).load_state_dict(
                _grads(jm, 4, step))
            jm, state = jopt.step(gm, jm, state)
        names = [n for n, _ in jm.named_parameters()]
        slots = {k: dict(zip(names, jax.tree_util.tree_leaves(
            state.slots[k], is_leaf=lambda x: isinstance(x, jme.QMoment))))
            for k in ("m", "v")}
        tm = gpt_from_jax_state_dict(
            GPTConfig(**SHAPE), {k: np.asarray(v, np.float32)
                                 for k, v in jm.state_dict().items()},
            device="cpu", dtype=torch.bfloat16)
        topt = MemoryEfficientAdamW(2e-3, moment_dtype=moment_dtype)
        topt.bind(tm.named_parameters())
        optimizer_from_jax_state(topt, int(state.step), slots)
        g = _grads(jm, 4, 2)
        gm = jax.tree_util.tree_map(lambda x: x, jm).load_state_dict(g)
        jm, state = jopt.step(gm, jm, state)
        for name, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[to_jax_key(name)]).to(p.dtype)
        topt.step()
        jp = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            np.testing.assert_array_equal(_bits(p), _bits(jp[to_jax_key(
                name)]), err_msg=f"{moment_dtype} {name}")


def test_library_name_covers_the_headers_a_source_includes(tmp_path):
    """The built library is named by a hash of its source, every
    ``csrc`` header it includes and the flags: a changed header gives
    another name, so no stale library is loaded."""
    import shutil

    from paddle_ray_tpu_torch.ops import _build
    src = tmp_path / "csrc"
    shutil.copytree(os.path.dirname(_build.csrc_path("me_adamw")), src)
    names = [os.path.basename(p) for p in _build.sources("me_adamw",
                                                          str(src))]
    assert names == ["me_adamw.cu", "threefry.cuh"]
    assert "threefry.cuh" in [os.path.basename(p) for p in
                              _build.sources("dropout", str(src))]
    before = {n: _build._target(n, str(src)) for n in ("me_adamw", "dropout",
                                                       "fused")}
    with open(src / "threefry.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: _build._target(n, str(src)) for n in before}
    assert after["me_adamw"] != before["me_adamw"]
    assert after["dropout"] != before["dropout"]
    assert after["fused"] == before["fused"]


def test_update_wrapper_refuses_what_the_kernel_does_not_take():
    from paddle_ray_tpu_torch.ops.me_adamw import me_adamw_update
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, l1=0.0, l2=0.0,
              bc1=0.1, bc2=0.001, block=256, key=None)
    p = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no me_adamw kernel"):
        me_adamw_update(p, p, p, p, None, **kw)
