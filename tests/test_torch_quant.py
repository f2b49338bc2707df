"""The port's weight-only int8 decode path against the JAX package.

``int8_stream_matmul``'s plain version against the Pallas kernel (in
interpret mode on the CPU), with and without bias, at 1, 8 and 129 rows
and a ragged N; ``quantize_for_decode``'s int8 weights, scales and the qkv
relayout bit for bit; both branches of ``WeightOnlyInt8Linear`` (the
kernel up to 128 rows, one matmul above); the int8 embedding; and a
quantized JAX state carried into the port by ``weights.py``.  Float
tolerances 1e-5 (float32; summation order differs)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import build_gpt as jax_build_gpt
from paddle_ray_tpu.models.generation import (
    _head_logits as jax_head_logits,
    quantize_for_decode as jax_quantize_for_decode)
from paddle_ray_tpu.ops.decode_matmul import (
    int8_stream_matmul as jax_int8_matmul)
from paddle_ray_tpu.quantization.quant import (
    WeightOnlyInt8Linear as JaxInt8Linear,
    quantize_per_channel as jax_quantize_per_channel)
from paddle_ray_tpu_torch.models.generation import (_head_logits,
                                                     quantize_for_decode)
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.ops import decode_matmul as dm
from paddle_ray_tpu_torch.ops.decode_matmul import (
    int8_stream_matmul, int8_stream_matmul_plain,
    int8_stream_matmul_split_plain, kernel_plan, stream_plan)
from paddle_ray_tpu_torch.quantization import (WeightOnlyInt8Embedding,
                                               WeightOnlyInt8Linear,
                                               quantize_per_channel)
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          gpt_to_jax_state_dict)

SHAPE = dict(vocab_size=97, max_seq_len=64, hidden_size=32, num_layers=2,
             num_heads=4, dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _matmul_inputs(seed, rows, k, n):
    r = np.random.RandomState(seed)
    x = r.randn(rows, k).astype(np.float32)
    w = r.randint(-128, 128, (k, n)).astype(np.int8)
    scale = (0.01 * r.rand(n) + 1e-3).astype(np.float32)
    bias = r.randn(n).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("rows", [1, 8, 129])
@pytest.mark.parametrize("n", [97, 384])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_stream_matmul_matches_jax(rows, n, with_bias):
    x, w, scale, bias = _matmul_inputs(rows + n, rows, 48, n)
    jb = jnp.asarray(bias) if with_bias else None
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(scale), jb))
    tb = torch.from_numpy(bias) if with_bias else None
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
            tb)
    got = int8_stream_matmul_plain(*args)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    before = int8_stream_matmul.launches
    torch.testing.assert_close(int8_stream_matmul(*args), got, rtol=0,
                               atol=0)
    assert int8_stream_matmul.launches == before


def test_int8_stream_matmul_bf16_matches_jax():
    x, w, scale, bias = _matmul_inputs(3, 8, 64, 128)
    want = jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                           jnp.asarray(scale), jnp.asarray(bias, jnp.bfloat16))
    got = int8_stream_matmul_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(scale), torch.from_numpy(bias).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("n", [97, 1024, 50304])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_stream_plan_covers_every_k_row_once(b, k, n):
    """The split plan of a launch on a 132-SM card: runs of a whole number
    of the kernel's 64-row stages, none empty, each K row in exactly one;
    runs of 2-4 stages where the column tiles alone leave SMs idle, and
    the LM head (393 column tiles) not split."""
    rows, n_splits = stream_plan(b, k, n, 132)
    assert rows % dm.STAGE_K == 0 and rows > 0
    covered = np.zeros(k, np.int64)
    for s in range(n_splits):
        run = covered[s * rows:min(k, (s + 1) * rows)]
        assert run.size > 0
        run += 1
    assert (covered == 1).all()
    tiles = -(-n // dm.TILE_N) * -(-b // dm.ROWS)
    if tiles >= 132:
        assert n_splits == 1
    else:
        assert dm.MIN_RUN_STAGES <= rows // dm.STAGE_K <= dm.MAX_RUN_STAGES
    if (b, k, n) == (8, 1024, 50304):
        assert n_splits == 1


def test_kernel_plan_is_stream_plan_on_the_card(monkeypatch):
    """Every launch reads its plan from ``stream_plan`` with the card's SM
    count."""
    from paddle_ray_tpu_torch.ops import _splitk
    monkeypatch.setitem(_splitk._SM_COUNT, "card", 132)
    for b, k, n in ((8, 1024, 3072), (8, 4096, 1024), (128, 1024, 1024)):
        assert kernel_plan(b, k, n, "card") == stream_plan(b, k, n, 132)


@pytest.mark.parametrize("rows", [1, 8, 128])
@pytest.mark.parametrize("with_bias", [False, True])
def test_stream_split_plain_matches_unsplit_and_jax(rows, with_bias):
    """The kernel's split-and-merge in plain PyTorch, with the plan a
    132-SM card takes and with two uneven runs: within 1e-6 of the
    unsplit plain version in float32, and the Pallas kernel in interpret
    mode within the file's tolerance."""
    x, w, scale, bias = _matmul_inputs(rows + 5, rows, 320, 96)
    x *= 0.05
    tb = torch.from_numpy(bias) if with_bias else None
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
            tb)
    whole = int8_stream_matmul_plain(*args)
    want = np.asarray(jax_int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias) if with_bias else None))
    for rps in (stream_plan(rows, 320, 96, 132)[0], 3 * dm.STAGE_K):
        got = int8_stream_matmul_split_plain(*args, rows_per_split=rps)
        assert got.shape == (rows, 96) and got.dtype == torch.float32
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quantize_per_channel_is_bit_exact():
    r = np.random.RandomState(4)
    w = (0.05 * r.randn(40, 24)).astype(np.float32)
    w[3] = 0.0                                      # an all-zero channel
    for axis in (0, 1):
        jq, js = jax_quantize_per_channel(jnp.asarray(w), axis=axis)
        tq, ts = quantize_per_channel(torch.from_numpy(w), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert quantize_per_channel(torch.full((2, 2), 1e3))[0].max() == 127


def _pair(seed, use_rotary=False, dtype=None):
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
    tm = gpt_from_jax_state_dict(
        GPTConfig(**SHAPE, use_rotary=use_rotary), state, device="cpu",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jm, tm


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_quantize_for_decode_is_bit_exact(dtype):
    jm, tm = _pair(11, dtype=dtype)
    jq = jax_quantize_for_decode(jm)
    tq = quantize_for_decode(tm)
    want = {k: np.asarray(v) for k, v in jq.state_dict().items()}
    got = gpt_to_jax_state_dict(tq)
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k].dtype == np.int8 or k.endswith(".scale"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_array_equal(
                got[k], np.asarray(want[k], np.float32), err_msg=k)
    assert all(blk.attn.qkv_contiguous for blk in tq.blocks)
    # the caller's model is left as it was
    assert not hasattr(tm.blocks[0].attn, "qkv_contiguous")
    assert isinstance(tm.blocks[0].attn.qkv.weight, torch.nn.Parameter)


@pytest.mark.parametrize("rows", [8, 129])
def test_int8_linear_branches_match_jax(rows):
    r = np.random.RandomState(rows)
    w = (0.1 * r.randn(32, 96)).astype(np.float32)
    b = r.randn(96).astype(np.float32)
    x = r.randn(rows, 32).astype(np.float32)
    jl = JaxInt8Linear.from_weight(jnp.asarray(w), jnp.asarray(b))
    tl = WeightOnlyInt8Linear.from_weight(torch.from_numpy(w),
                                          torch.from_numpy(b))
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # [B, S, K] inputs reshape around the same branch
    got3 = tl(torch.from_numpy(x).reshape(1, rows, 32)).numpy()
    np.testing.assert_allclose(got3[0], want, **TOL)


def test_int8_embedding_and_head_match_jax():
    jm, tm = _pair(12, use_rotary=True)
    jq, tq = jax_quantize_for_decode(jm), quantize_for_decode(tm)
    ids = np.random.RandomState(5).randint(0, 97, (3, 7)).astype(np.int32)
    want = np.asarray(jq.embedding.word_embeddings(jnp.asarray(ids)))
    got = tq.embedding.word_embeddings(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(tq.embedding.word_embeddings, WeightOnlyInt8Embedding)
    # 3 and 21 rows take the weight-streaming kernel on weight_qT, 140 rows
    # the plain matmul on weight_q
    for shape in ((3, 1, 32), (3, 7, 32), (2, 70, 32)):
        h = np.random.RandomState(6).randn(*shape).astype(np.float32)
        with torch.no_grad():
            th = _head_logits(tq, torch.from_numpy(h))
        np.testing.assert_allclose(
            th.numpy(), np.asarray(jax_head_logits(jq, jnp.asarray(h))),
            **TOL)


def test_quantized_jax_state_loads_through_weights():
    jm, _ = _pair(13, use_rotary=True)
    jq = jax_quantize_for_decode(jm)
    state = {k: np.asarray(v) for k, v in jq.state_dict().items()}
    tq = gpt_from_jax_state_dict(GPTConfig(**SHAPE, use_rotary=True), state,
                                 device="cpu")
    back = gpt_to_jax_state_dict(tq)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)
    assert back["blocks.items.0.attn.qkv.weight_q"].dtype == np.int8
    assert all(blk.attn.qkv_contiguous for blk in tq.blocks)
    h = np.random.RandomState(8).randn(2, 1, 32).astype(np.float32)
    with torch.no_grad():
        th = _head_logits(tq, torch.from_numpy(h))
    np.testing.assert_allclose(
        th.numpy(), np.asarray(jax_head_logits(jq, jnp.asarray(h))), **TOL)
    bad = dict(state)
    del bad["embedding.word_embeddings.weight_qT"]
    with pytest.raises(KeyError):
        gpt_from_jax_state_dict(GPTConfig(**SHAPE, use_rotary=True), bad,
                                device="cpu")


def test_validation():
    x, w, scale, _ = (torch.from_numpy(a) for a in
                      _matmul_inputs(9, 2, 16, 8))
    with pytest.raises(ValueError):            # K mismatch
        int8_stream_matmul(x[:, :15], w, scale)
    with pytest.raises(ValueError):            # scale of the wrong length
        int8_stream_matmul(x, w, scale[:7])
    with pytest.raises(ValueError):            # no kernel for this device
        int8_stream_matmul(x.to("meta"), w.to("meta"), scale.to("meta"))
