"""The port's checkpoints on the CPU: the single-device cases of
``tests/test_checkpoint.py`` -- pickle-free ``save`` / ``load`` (int dict
keys, the atomic overwrite, a module's state dict), the whole-state tree
format with a target, ``restore_train_state`` resuming training, and
``CheckpointManager``'s retention and resume, uncommitted steps ignored,
GC that never touches an uncommitted step, the orphan reaper, a failed
re-save that keeps the committed step, the manifest with its meta, and a
corrupt step falling back to the previous one -- and files passing both
ways between the packages: a tree with a bfloat16 leaf saved by
``paddle_ray_tpu.checkpoint.save`` loads equal in the port, and the
port's file loads in the JAX package."""
import json
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_ray_tpu import checkpoint as jax_checkpoint
from paddle_ray_tpu_torch.checkpoint import (CheckpointManager, load,
                                             load_sharded, load_state_dict,
                                             restore_train_state, save,
                                             save_sharded, save_state_dict)
from paddle_ray_tpu_torch.checkpoint import sharded
from paddle_ray_tpu_torch.models import gpt_loss_fn
from paddle_ray_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_ray_tpu_torch.nn.layers import Linear
from paddle_ray_tpu_torch.optimizer import AdamW
from paddle_ray_tpu_torch.parallel import build_train_step

CFG = GPTConfig(vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=2,
                num_heads=4, dtype="float32", attn_impl="dense")


def _gpt(seed):
    torch.manual_seed(seed)
    return GPT(CFG, device="cpu")


def test_save_load_roundtrip(tmp_path):
    obj = {
        "step": 7,
        "lr": 0.1,
        "name": "run1",
        "arrays": [torch.arange(6).reshape(2, 3), np.ones((4,), np.float32)],
        "nested": {"t": (torch.zeros((2,)), 3, None)},
    }
    save(obj, str(tmp_path / "ck"))
    back = load(str(tmp_path / "ck"))
    assert back["step"] == 7 and back["lr"] == 0.1 and back["name"] == "run1"
    assert torch.equal(back["arrays"][0], torch.arange(6).reshape(2, 3))
    assert torch.equal(back["arrays"][1], torch.ones(4))
    assert isinstance(back["nested"]["t"], tuple)
    assert back["nested"]["t"][1] == 3 and back["nested"]["t"][2] is None


def test_save_rejects_unsupported(tmp_path):
    with pytest.raises(TypeError):
        save({"fn": lambda x: x}, str(tmp_path / "bad"))
    with pytest.raises(TypeError):
        save({(1, 2): torch.ones(1)}, str(tmp_path / "badkey"))


def test_save_load_int_dict_keys(tmp_path):
    obj = {0: torch.ones((2,)), 1: torch.zeros((2,)), "s": 3}
    save(obj, str(tmp_path / "ik"))
    back = load(str(tmp_path / "ik"))
    assert set(back.keys()) == {0, 1, "s"}
    assert torch.equal(back[0], torch.ones(2))


def test_save_overwrite_is_atomic(tmp_path):
    p = str(tmp_path / "ow")
    save({"a": torch.arange(3)}, p)
    save({"a": torch.arange(5)}, p)
    back = load(p)
    assert torch.equal(back["a"], torch.arange(5))
    assert len([n for n in os.listdir(p) if n.startswith("arrays")]) == 1


def test_model_state_dict_roundtrip(tmp_path):
    torch.manual_seed(0)
    m = Linear(4, 3)
    save_state_dict(m, str(tmp_path / "m"))
    torch.manual_seed(1)
    m2 = Linear(4, 3)
    assert not torch.equal(m.weight, m2.weight)
    load_state_dict(m2, str(tmp_path / "m"))
    assert torch.equal(m.weight, m2.weight)
    assert torch.equal(m.bias, m2.bias)


def test_bfloat16_leaf_from_the_jax_package_loads_in_the_port(tmp_path):
    """``np.savez`` stores the JAX bfloat16 leaf as untagged ``|V2``: the
    port reads it as bfloat16, bit for bit."""
    r = np.random.RandomState(0)
    w = r.randn(5, 7).astype(np.float32)
    obj = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(w[0]),
           "i8": np.arange(-4, 4, dtype=np.int8), 3: (1, "x")}
    jax_checkpoint.save(obj, str(tmp_path / "j"))
    back = load(str(tmp_path / "j"))
    assert back["w"].dtype == torch.bfloat16
    want = np.asarray(obj["w"]).view(np.uint16)
    assert np.array_equal(back["w"].view(torch.int16).numpy().view(np.uint16),
                          want)
    assert torch.equal(back["b"], torch.from_numpy(w[0]))
    assert back["i8"].dtype == torch.int8 and back[3] == (1, "x")


def test_port_file_loads_in_the_jax_package(tmp_path):
    """The port's bfloat16 leaf is the ``|V2`` the JAX package writes (with
    a ``dtype`` tag its reader ignores)."""
    r = np.random.RandomState(1)
    w = torch.from_numpy(r.randn(6, 3).astype(np.float32))
    obj = {"w": w.to(torch.bfloat16), "f": w, 0: [torch.arange(4), 2.5]}
    save(obj, str(tmp_path / "t"))
    back = jax_checkpoint.load(str(tmp_path / "t"))
    got = back["w"].view(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(got, obj["w"].float().numpy())
    assert np.array_equal(back["f"], w.numpy())
    assert np.array_equal(back[0][0], np.arange(4)) and back[0][1] == 2.5
    # and the JAX file of the same tree holds the same bytes
    jax_checkpoint.save({"w": jnp.asarray(w.numpy(), jnp.bfloat16)},
                        str(tmp_path / "j"))
    assert jax_checkpoint.load(str(tmp_path / "j"))["w"].tobytes() == \
        back["w"].tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8, torch.uint8,
                                   torch.int32, torch.int64, torch.bool])
def test_tree_format_roundtrips_bit_for_bit(tmp_path, dtype):
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(3, 5).astype(np.float32) * 50)
    t = x.to(dtype) if dtype != torch.bool else x > 0
    tree = {"t": t, "empty": torch.zeros(0, dtype=dtype),
            "scalar": t.reshape(-1)[0].clone(), "meta": {"lr": None},
            "view": t[:, 1:3]}
    save_sharded(tree, str(tmp_path / "s"))
    back = load_sharded(str(tmp_path / "s"))
    for k in ("t", "empty", "scalar", "view"):
        assert back[k].dtype == dtype and back[k].shape == tree[k].shape
        assert torch.equal(back[k], tree[k]), k
    assert back["meta"] == {"lr": None}
    md = sharded.ShardedCheckpointer().metadata(str(tmp_path / "s"))
    assert md["t"] == sharded.LeafMeta(dtype, (3, 5))
    with open(os.path.join(tmp_path, "s", "tree.json")) as f:
        doc = json.load(f)
    nodes = [n for _, n in doc["tree"]["__dict__"] if isinstance(n, dict)
             and "__tensor__" in n]
    assert len(nodes) == 4 and all(n["offset"] % 64 == 0 for n in nodes)
    assert os.path.getsize(os.path.join(tmp_path, "s", "data.bin")) == \
        doc["nbytes"] == nodes[-1]["offset"] + nodes[-1]["nbytes"]


def test_load_sharded_into_target(tmp_path):
    m = _gpt(2)
    path = str(tmp_path / "sharded")
    save_sharded({"model": m.state_dict()}, path)
    target = {"model": {k: torch.zeros_like(v, dtype=torch.float64)
                        for k, v in m.state_dict().items()}}
    back = load_sharded(path, target=target)
    for k, v in m.state_dict().items():
        assert back["model"][k].dtype == torch.float64
        assert torch.equal(back["model"][k], v.double())
    bad = {"model": {"embedding.position_embeddings": torch.zeros(3)}}
    with pytest.raises(ValueError, match="shape"):
        load_sharded(path, target=bad)
    with pytest.raises(NotImplementedError):
        load_sharded(path, shardings={"model": None})


def test_restore_train_state_resumes_training(tmp_path):
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (8, 16)))
    ts = build_train_step(_gpt(3), AdamW(1e-2), gpt_loss_fn)
    for _ in range(3):
        ts.step((ids, ids))
    path = str(tmp_path / "ts")
    save_sharded(ts.capture(), path)
    l4 = float(ts.step((ids, ids)))
    ts2 = build_train_step(_gpt(4), AdamW(1e-2), gpt_loss_fn)
    restore_train_state(path, ts2)
    assert ts2.step_count == 3
    assert float(ts2.step((ids, ids))) == l4


def test_checkpoint_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                            save_interval_steps=5, use_async=True)
    assert mgr.latest_step() is None
    assert mgr.should_save(10) and not mgr.should_save(11)
    tree = {"w": torch.arange(4.0)}
    for s in (5, 10, 15):
        mgr.save(s, {"w": tree["w"] + s})
    mgr.wait()
    assert mgr.all_steps() == [10, 15]
    assert mgr.latest_step() == 15
    back = mgr.restore(target=tree)
    assert torch.equal(back["w"], torch.arange(4.0) + 15)
    mgr.close()


def test_checkpoint_manager_ignores_uncommitted(tmp_path):
    d = tmp_path / "run2"
    os.makedirs(d / "step_3")  # no COMMITTED marker: a crashed save
    mgr = CheckpointManager(str(d))
    assert mgr.latest_step() is None
    mgr.close()


def test_checkpoint_manager_gc_never_touches_uncommitted(tmp_path):
    """Retention counts and deletes committed steps only: an uncommitted
    directory neither inflates the count nor becomes a victim; it is
    reaped as an orphan."""
    d = tmp_path / "run3"
    mgr = CheckpointManager(str(d), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.arange(4.0) + s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    os.remove(os.path.join(mgr.step_path(3), "COMMITTED"))
    mgr2 = CheckpointManager(str(d), max_to_keep=2)
    assert mgr2.latest_step() == 2
    assert mgr2.latest_step(verified=True) == 2
    assert not os.path.exists(mgr2.step_path(3))
    back = mgr2.restore(target={"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.arange(4.0) + 2)
    shutil.rmtree(str(d / "step_9"), ignore_errors=True)
    mgr2.save(9, {"w": torch.arange(4.0) + 9})
    mgr2.wait()
    assert mgr2.all_steps() == [2, 9]
    mgr2.close()


def test_orphan_reaper_promotes_committed_scratch_dir(tmp_path):
    """A crash between the commit's rmtree and rename leaves a whole
    commit under its scratch name: the reaper promotes it into place."""
    d = str(tmp_path / "run6")
    mgr = CheckpointManager(d)
    mgr.save(7, {"w": torch.arange(6.0)})
    mgr.wait()
    mgr.close()
    shutil.move(os.path.join(d, "step_7"),
                os.path.join(d, ".step_7.pending-deadbeef"))
    mgr2 = CheckpointManager(d)
    assert mgr2.latest_step(verified=True) == 7
    back = mgr2.restore(target={"w": torch.zeros(6)})
    assert torch.equal(back["w"], torch.arange(6.0))
    mgr2.close()


def test_orphan_reaper_removes_torn_scratch_dir(tmp_path):
    d = str(tmp_path / "run7")
    mgr = CheckpointManager(d)
    mgr.save(2, {"w": torch.arange(3.0)})
    mgr.abandon()                       # a death before the commit
    assert [n for n in os.listdir(d) if "pending" in n]
    mgr2 = CheckpointManager(d)
    assert os.listdir(d) == [] and mgr2.latest_step() is None


def test_failed_resave_preserves_committed_step(tmp_path):
    """Re-saving a committed step writes into scratch and renames at the
    commit: a save that fails leaves the old checkpoint restorable."""
    mgr = CheckpointManager(str(tmp_path / "run5"))
    mgr.save(5, {"w": torch.arange(4.0)})
    mgr.wait()

    def boom(kind, step):
        raise OSError("disk full")

    mgr.fault_injector = boom
    with pytest.raises(OSError):
        mgr.save(5, {"w": torch.zeros(4)})
    mgr.fault_injector = None
    assert mgr.latest_step(verified=True) == 5
    back = mgr.restore(5, target={"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.arange(4.0))
    mgr.close()


def test_checkpoint_manager_manifest_and_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run4"))
    mgr.save(5, {"w": torch.arange(8.0)}, meta={"schema": "graftsurvive/1",
                                                "step": 5})
    mgr.wait()
    ok, why = mgr.verify_step(5)
    assert ok, why
    doc = mgr.load_manifest(5)
    assert doc["meta"]["schema"] == "graftsurvive/1"
    assert sorted(doc["files"]) == ["state/data.bin", "state/tree.json"]
    assert all("crc32" in v and "bytes" in v for v in doc["files"].values())
    # a committed checkpoint with no manifest (from before manifests)
    # stays restorable
    os.remove(os.path.join(mgr.step_path(5), "MANIFEST.json"))
    ok, why = mgr.verify_step(5)
    assert ok and "legacy" in why
    back = mgr.restore(target={"w": torch.zeros(8)})
    assert torch.equal(back["w"], torch.arange(8.0))
    mgr.close()


@pytest.mark.parametrize("damage", ["flip", "truncate", "remove"])
def test_corrupt_step_falls_back_to_previous(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path / "run8"), max_to_keep=3)
    for s in (1, 2):
        mgr.save(s, {"w": torch.arange(32.0) * s})
    mgr.wait()
    data = os.path.join(mgr.step_path(2), "state", "data.bin")
    if damage == "flip":
        with open(data, "r+b") as f:
            f.seek(9)
            b = f.read(1)
            f.seek(9)
            f.write(bytes([b[0] ^ 0x01]))
    elif damage == "truncate":
        os.truncate(data, 17)
    else:
        os.remove(data)
    with pytest.warns(UserWarning, match="failed verification"):
        assert mgr.latest_step(verified=True) == 1
    with pytest.warns(UserWarning, match="failed verification"):
        back = mgr.restore(target={"w": torch.zeros(32)})
    assert torch.equal(back["w"], torch.arange(32.0))
    mgr.close()
