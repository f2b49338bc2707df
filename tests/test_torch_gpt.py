"""The port's GPT and its paged mixed step against the JAX package.

Both sides hold the same weights: a JAX model's state dict, randomised
with numpy (biases and norms included), loaded into the JAX model and
carried into the port by ``gpt_from_jax_state_dict``.  Tolerances:
float32 logits 1e-4 (matmul summation order differs), which pins the tanh
GELU (PyTorch's default erf GELU misses by about 4e-4); pool rows 1e-5;
bfloat16 2e-2, which pins the float32 LayerNorm (a bfloat16 LayerNorm
misses by about 3e-2)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.serving.engine import paged_mixed_step as jax_mixed_step
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.serving.engine import paged_mixed_step
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          gpt_to_jax_state_dict)

# the configuration of tests/test_serving.py
SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)


def _pair(seed, use_rotary, dtype=None):
    """(JAX model, port model, the shared state dict)."""
    prt.seed(seed)
    jm = jax_build_gpt(JaxGPTConfig(**SHAPE, use_rotary=use_rotary,
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
    cfg = GPTConfig(**SHAPE, use_rotary=use_rotary)
    tm = gpt_from_jax_state_dict(
        cfg, state, device="cpu",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jm, tm, state


def test_weight_converter_round_trips_exactly():
    for rotary in (False, True):
        _, tm, state = _pair(1, rotary)
        back = gpt_to_jax_state_dict(tm)
        assert sorted(back) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    cfg = GPTConfig(**SHAPE, use_rotary=True)
    bad = dict(state)
    bad["blocks.items.0.attn.qkv.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        gpt_from_jax_state_dict(cfg, bad, device="cpu")
    missing = {k: v for k, v in state.items() if "head.norm" not in k}
    with pytest.raises(KeyError):
        gpt_from_jax_state_dict(cfg, missing, device="cpu")
    extra = dict(state, **{"head.proj.weight": np.zeros((32, 97))})
    with pytest.raises(KeyError):
        gpt_from_jax_state_dict(cfg, extra, device="cpu")


@pytest.mark.parametrize("use_rotary", [False, True])
def test_forward_logits_match_jax(use_rotary):
    jm, tm, _ = _pair(2, use_rotary)
    ids = np.random.RandomState(3).randint(0, 97, (2, 19)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches_jax():
    jm, tm, _ = _pair(4, False, dtype="bfloat16")
    ids = np.random.RandomState(5).randint(0, 97, (2, 16)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids)).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def _mixed_inputs(seed, cfg, page=8, blocks=4, s=4, c=8):
    """One decode slot, one prefill chunk from position 0, one mid-prompt
    tail, one dead slot, over shuffled pages of a random pool."""
    r = np.random.RandomState(seed)
    n = 1 + s * blocks
    shape = (cfg.num_layers, n, page, cfg.num_heads, cfg.head_dim)
    pools = [r.randn(*shape).astype(np.float32) for _ in range(2)]
    table = (1 + r.permutation(n - 1)).astype(np.int32).reshape(s, blocks)
    starts, q_lens = [13, 0, 16, 0], [1, 8, 5, 0]
    toks = np.zeros((s, c), np.int32)
    positions = np.zeros((s, c), np.int32)
    for i, (st, ql) in enumerate(zip(starts, q_lens)):
        toks[i, :ql] = r.randint(0, cfg.vocab_size, ql)
        positions[i, :ql] = np.arange(st, st + ql)
    q_lens = np.asarray(q_lens, np.int32)
    lengths = np.where(q_lens > 0, np.asarray(starts) + q_lens, 0) \
        .astype(np.int32)
    return toks, positions, q_lens, lengths, table, pools


@pytest.mark.parametrize("use_rotary", [False, True])
def test_paged_mixed_step_matches_jax(use_rotary):
    jm, tm, _ = _pair(6, use_rotary)
    toks, positions, q_lens, lengths, table, pools = _mixed_inputs(
        7, tm.cfg)
    j_pools, j_logits = jax_mixed_step(
        jm, *(jnp.asarray(a) for a in (toks, positions, q_lens, lengths,
                                       table)),
        tuple(jnp.asarray(p) for p in pools))
    t_pools = tuple(torch.from_numpy(p.copy()) for p in pools)
    with torch.no_grad():
        t_pools, t_logits = paged_mixed_step(
            tm, *(torch.from_numpy(a) for a in (toks, positions, q_lens,
                                                lengths, table)), t_pools)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    # the rows written into real pages (page 0 takes the pad rows' junk)
    for got, want, before in zip(t_pools, j_pools, pools):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:],
                                   rtol=1e-5, atol=1e-5)
        assert not np.array_equal(got.numpy()[:, 1:], before[:, 1:])


def test_paged_decode_step_matches_jax():
    """The ``C == 1`` view: one token per slot, a dead slot among them."""
    from paddle_ray_tpu.serving.engine import (
        paged_decode_step as jax_decode_step)
    from paddle_ray_tpu_torch.serving.engine import paged_decode_step
    jm, tm, _ = _pair(8, True)
    _, _, _, _, table, pools = _mixed_inputs(9, tm.cfg)
    toks = np.asarray([5, 17, 0, 42], np.int32)
    positions = np.asarray([13, 31, 0, 7], np.int32)
    lengths = np.where(np.arange(4) == 2, 0, positions + 1).astype(np.int32)
    _, j_logits = jax_decode_step(
        jm, *(jnp.asarray(a) for a in (toks, positions, lengths, table)),
        tuple(jnp.asarray(p) for p in pools))
    with torch.no_grad():
        _, t_logits = paged_decode_step(
            tm, *(torch.from_numpy(a) for a in (toks, positions, lengths,
                                                table)),
            tuple(torch.from_numpy(p.copy()) for p in pools))
    live = [0, 1, 3]                # a dead slot's logits are junk
    np.testing.assert_allclose(t_logits.numpy()[live],
                               np.asarray(j_logits)[live],
                               rtol=1e-4, atol=1e-4)
