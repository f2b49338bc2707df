"""The port's BERT pretraining path against the JAX package: the dense
attention's padding mask, the flash path's segment ids, the MLM + NSP
loss with every gradient, the 3-step AdamW curve through
``build_train_step``, embedding dropout under one key, and the weight
bridge.  Also the functional pieces BERT adds: ``cross_entropy``,
``tanh`` and the dense attention's ``mask``.

Both sides hold the same weights: a numpy state dict loaded into the JAX
model (built from its abstract shapes, so no eager random init compiles)
and carried into the port by ``bert_from_jax_state_dict``.  The tiny
config is bench.py's CPU BERT (vocab 512, hidden 64, 2 layers, 4 heads);
batch 2 of 32 tokens, padded to lengths 32 and 19 where a case pads.  The
JAX flash attention runs its Pallas kernels in interpret mode, the port's
its plain versions (CPU tensors).  Tolerances: float32 logits ``rtol`` and
``atol`` 1e-5, losses 1e-5, gradients ``rtol=1e-4, atol=1e-5`` per
parameter, the float32 loss curve ``rtol`` 1e-4 (summation orders
differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.core.rng import key_scope
from paddle_ray_tpu.core.training import value_and_grad as jax_value_and_grad
from paddle_ray_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_ray_tpu.models.bert import BertForPretraining as JaxBert
from paddle_ray_tpu.models.bert import \
    bert_pretrain_loss_fn as jax_bert_loss_fn
from paddle_ray_tpu.nn import functional as JF
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu_torch.models import (BERT_CONFIGS, BertConfig,
                                         BertForPretraining, bert_config,
                                         bert_pretrain_loss_fn)
from paddle_ray_tpu_torch.nn import functional as F
from paddle_ray_tpu_torch.optimizer import AdamW
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.weights import (bert_from_jax_state_dict,
                                          bert_to_jax_state_dict)

# bench.py:1601-1603, the CPU BERT
TINY = dict(vocab_size=512, max_seq_len=32, hidden_size=64, num_layers=2,
            num_heads=4)
B, S = 2, 32
LENGTHS = (32, 19)
LR, STEPS = 1e-3, 3


def _jax_bert(attn_impl, dropout=0.0):
    cfg = JaxBertConfig(**TINY, attn_impl=attn_impl, dropout=dropout)

    def build(key):
        with key_scope(key):
            return JaxBert(cfg)
    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)


def _state(seed=0):
    r = np.random.RandomState(seed)
    jm = _jax_bert("dense")
    state = {}
    for k, a in sorted(jm.state_dict().items()):
        if "norm" in k and k.endswith(".weight"):
            a = 1.0 + 0.2 * r.randn(*a.shape)
        elif a.ndim > 1:
            a = r.randn(*a.shape) * 0.5 / np.sqrt(a.shape[-1])
        else:
            a = 0.1 * r.randn(*a.shape)
        state[k] = a.astype(np.float32)
    return state


STATE = _state()


def _pair(attn_impl, dropout=0.0):
    jm = _jax_bert(attn_impl, dropout)
    jm.load_state_dict(STATE)
    tm = bert_from_jax_state_dict(
        BertConfig(**TINY, attn_impl=attn_impl, dropout=dropout), STATE,
        device="cpu")
    return jm, tm


def _batch(padded, seed=1):
    r = np.random.RandomState(seed)
    batch = {"ids": r.randint(0, 512, (B, S)).astype(np.int32),
             "token_type_ids": (np.arange(S)[None, :] >= 12).repeat(
                 B, 0).astype(np.int32),
             "mlm_labels": r.randint(0, 512, (B, S)).astype(np.int32),
             "nsp_labels": np.asarray([0, 1], np.int32)}
    batch["mlm_labels"][r.rand(B, S) < 0.3] = -100
    if padded:
        batch["attention_mask"] = (np.arange(S)[None, :]
                                   < np.asarray(LENGTHS)[:, None]).astype(
                                       np.int32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side, once per (attn_impl, padding): logits, the loss and
    every gradient; and each attn_impl's 3-step AdamW curve on a
    one-device mesh (the process's topology is put back)."""
    out = {}
    for impl in ("dense", "flash"):
        for padded in (False, True):
            jm, _ = _pair(impl)
            jb = _jax_batch(_batch(padded))

            def loss_and_logits(m, b):
                mlm, nsp = m(b["ids"], b["token_type_ids"],
                             b.get("attention_mask"))
                return jax_bert_loss_fn(m, b), (mlm, nsp)
            (loss, (mlm, nsp)), grads = jax.jit(jax_value_and_grad(
                loss_and_logits, has_aux=True))(jm, jb)
            out[impl, padded] = {
                "loss": float(loss), "mlm": np.asarray(mlm),
                "nsp": np.asarray(nsp),
                "grads": {k: np.asarray(v)
                          for k, v in grads.named_parameters()}}
    saved = current_topology()
    try:
        topo = init_hybrid_mesh(dp=1, devices=jax.devices()[:1])
        for impl in ("dense", "flash"):
            jm, _ = _pair(impl)
            ts = jax_build_train_step(jm, jax_optim.AdamW(LR),
                                      jax_bert_loss_fn, topo=topo,
                                      donate=False)
            jb = _jax_batch(_batch(True))
            out["curve", impl] = [float(ts.step(jb)) for _ in range(STEPS)]
    finally:
        set_topology(saved)
    return out


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_and_loss_match_jax(attn_impl, padded, jax_ref):
    _, tm = _pair(attn_impl)
    ref = jax_ref[attn_impl, padded]
    b = _port_batch(_batch(padded))
    with torch.no_grad():
        mlm, nsp = tm(b["ids"], b["token_type_ids"],
                      b.get("attention_mask"))
        loss = bert_pretrain_loss_fn(tm, b)
    assert mlm.shape == (B, S, 512) and nsp.shape == (B, 2)
    np.testing.assert_allclose(mlm.numpy(), ref["mlm"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nsp.numpy(), ref["nsp"], rtol=1e-5, atol=1e-5)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_every_grad_matches_jax(attn_impl, padded, jax_ref):
    _, tm = _pair(attn_impl)
    bert_pretrain_loss_fn(tm, _port_batch(_batch(padded))).backward()
    grads = jax_ref[attn_impl, padded]["grads"]
    names = {n: n.replace("bert.layers.", "bert.layers.items.")
             for n, _ in tm.named_parameters()}
    assert sorted(names.values()) == sorted(grads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[names[name]],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_train_step_loss_curve_matches_jax(attn_impl, jax_ref):
    """Three AdamW(1e-3) steps on the padded batch from the same
    weights."""
    _, tm = _pair(attn_impl)
    ts = build_train_step(tm, AdamW(LR), bert_pretrain_loss_fn)
    b = _port_batch(_batch(True))
    got = [float(ts.step(b)) for _ in range(STEPS)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, jax_ref["curve", attn_impl], rtol=1e-4)


def test_flash_pads_as_segments_not_as_a_key_mask():
    """Flash encodes padding as segment ids: valid tokens see the same
    keys as under the dense key mask (equal outputs there), pad tokens
    see only pad keys (different outputs there), as in JAX."""
    _, dense = _pair("dense")
    _, flash = _pair("flash")
    b = _port_batch(_batch(True))
    with torch.no_grad():
        hd, _ = dense.bert(b["ids"], b["token_type_ids"], b["attention_mask"])
        hf, _ = flash.bert(b["ids"], b["token_type_ids"], b["attention_mask"])
    torch.testing.assert_close(hf[0], hd[0], rtol=1e-5, atol=1e-5)
    n = LENGTHS[1]
    torch.testing.assert_close(hf[1, :n], hd[1, :n], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(hf[1, n:], hd[1, n:])


def test_embedding_dropout_matches_jax():
    """With ``dropout > 0`` and a key, the embeddings' dropout draws the
    JAX mask (the only dropout of the JAX BERT); without a key, none."""
    jm, tm = _pair("dense", dropout=0.1)
    batch = _batch(False)
    key = jax.random.PRNGKey(42)
    want = jm(jnp.asarray(batch["ids"]), rng=key)
    b = _port_batch(batch)
    with torch.no_grad():
        got = tm(b["ids"], rng=np.asarray(jax.random.key_data(key)))
        plain = tm(b["ids"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert not torch.allclose(got[0], plain[0])


def test_weight_bridge_round_trip_and_configs():
    tm = bert_from_jax_state_dict(BertConfig(**TINY), STATE, device="cpu")
    back = bert_to_jax_state_dict(tm)
    assert sorted(back) == sorted(STATE)
    for k, a in STATE.items():
        assert np.array_equal(back[k], a), k
    missing = {k: a for k, a in STATE.items() if k != "nsp.bias"}
    with pytest.raises(KeyError):
        bert_from_jax_state_dict(BertConfig(**TINY), missing, device="cpu")
    wrong = dict(STATE, **{"nsp.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        bert_from_jax_state_dict(BertConfig(**TINY), wrong, device="cpu")
    large = bert_config("bert-large", max_seq_len=512, attn_impl="flash")
    assert (large.hidden_size, large.num_layers, large.num_heads,
            large.d_ffn, large.vocab_size) == (1024, 24, 16, 4096, 30522)
    assert sorted(BERT_CONFIGS) == ["bert-base", "bert-large",
                                    "ernie-3.0-base", "ernie-3.0-medium"]
    with pytest.raises(KeyError):
        bert_config("bert-huge")
    with pytest.raises(ValueError):
        BertForPretraining(BertConfig(**dict(TINY, attn_impl="ring")),
                           device="cpu")


def test_init_stds_follow_the_jax_file():
    g = torch.Generator()
    g.manual_seed(0)
    cfg = BertConfig(vocab_size=4096, max_seq_len=256, hidden_size=256,
                     num_layers=4, num_heads=4)
    m = BertForPretraining(cfg, device="cpu", generator=g)
    layer = m.bert.layers[0]
    out_std = 0.02 / np.sqrt(2 * 4)
    for p, std in ((m.bert.embeddings.word_embeddings.weight, 0.02),
                   (m.bert.embeddings.position_embeddings, 0.02),
                   (layer.qkv.weight, 0.02), (layer.fc1.weight, 0.02),
                   (layer.attn_out.weight, out_std),
                   (layer.fc2.weight, out_std)):
        assert abs(float(p.detach().std()) / std - 1) < 0.05
    assert torch.equal(layer.attn_norm.weight, torch.ones(256))
    assert layer.attn_norm.epsilon == 1e-12
    # xavier-uniform pooler: limit sqrt(6 / (256 + 256))
    assert float(m.bert.pooler.weight.detach().abs().max()) <= np.sqrt(
        6 / 512)


def test_cross_entropy_tanh_and_masked_attention_match_jax():
    r = np.random.RandomState(3)
    logits = (3 * r.randn(4, 7, 11)).astype(np.float32)
    labels = r.randint(0, 11, (4, 7)).astype(np.int32)
    labels[0, :3] = -100
    fives = r.randint(0, 11, (4, 7)).astype(np.int32)
    for lab, kw in ((labels, dict()), (labels, dict(reduction="sum")),
                    (labels, dict(reduction="none")),
                    (fives, dict(ignore_index=5))):
        want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(lab), **kw)
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(lab), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(F.tanh(torch.from_numpy(logits)).numpy(),
                               np.tanh(logits), rtol=1e-6, atol=1e-6)
    q, k, v = (r.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    mask = r.rand(2, 1, 16, 16) > 0.3
    mask[..., 0] = True
    for kw in (dict(), dict(causal=True)):
        want = JF.scaled_dot_product_attention(
            *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), **kw)
        got = F.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            torch.from_numpy(mask), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
