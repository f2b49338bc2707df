"""The port's resilient train loop against the JAX package's, on the CPU
and one device (``tests/test_survive.py``'s tiny ``CFG``).

The contract: kill the run at any step -- between an overlapped save and
its commit too -- resume, and the loss curve equals the uninterrupted one
bit for bit.  Held here: ``TrainFaultPlan.random`` draws the JAX plan's
events seed for seed; the unit cases of ``tests/test_survive.py`` on one
device (capture schema and the legacy ``{"model", "opt"}`` dump, options
that do not match, the scaler's state, a kill between save and commit, a
corrupt step, a save-IO fault, preemption, a fetch fault); a 20-seed
kill-anywhere property with its suite floor; the port's uninterrupted
curve against the JAX loop's (five float32 steps to ``rtol=1e-4``, the
tolerance of ``tests/test_torch_train.py``: summation order differs); a
JAX capture carried into the port by ``train_state_from_jax_capture``,
going on to the JAX curve's later steps within that tolerance; a save
whose writer is held until after the next step still holds the saved
step's state; a resume of ``MemoryEfficientAdamW`` (int8 moments, with
and without float32 masters, offloaded state) under a ``GradScaler``, bit
for bit; and graftlint's ``chaos-hook`` pass over the loop, its plan and
the manager.

Left out, with the reason: the JAX loop's telemetry cases
(``test_kill_dump_contains_reproducer``, ``test_loop_telemetry_records``;
the port's loop has no telemetry), and the mesh-only ones
(``test_capture_is_shard_local_no_gather``,
``test_full_state_roundtrip_zero3_int4``,
``test_reshard_on_load_dp4_to_dp2``: ZeRO sharding, quantized gradient
communication and resharding are multi-device features the port does not
run).
"""
import ast
import glob
import os
import signal
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_ray_tpu as prt
from paddle_ray_tpu.models import GPT as JaxGPT
from paddle_ray_tpu.models import GPTConfig as JaxGPTConfig
from paddle_ray_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from paddle_ray_tpu import optimizer as jax_optim
from paddle_ray_tpu.parallel import build_train_step as jax_build_train_step
from paddle_ray_tpu.parallel import init_hybrid_mesh
from paddle_ray_tpu.parallel.mesh import current_topology, set_topology
from paddle_ray_tpu.train import ResilientTrainLoop as JaxResilientTrainLoop
from paddle_ray_tpu.train import TrainFaultPlan as JaxTrainFaultPlan
from paddle_ray_tpu_torch.amp import GradScaler
from paddle_ray_tpu_torch.checkpoint import (CheckpointManager,
                                             restore_train_state,
                                             save_sharded)
from paddle_ray_tpu_torch.checkpoint import sharded
from paddle_ray_tpu_torch.models import gpt_loss_fn
from paddle_ray_tpu_torch.models.gpt import GPTConfig
from paddle_ray_tpu_torch.optimizer import AdamW, MemoryEfficientAdamW
from paddle_ray_tpu_torch.parallel import build_train_step
from paddle_ray_tpu_torch.train import (ChaosKill, PreemptSignal,
                                        ResilientTrainLoop, TrainFaultEvent,
                                        TrainFaultPlan)
from paddle_ray_tpu_torch.weights import (gpt_from_jax_state_dict,
                                          train_state_from_jax_capture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, max_seq_len=8, hidden_size=32, num_layers=1,
           num_heads=2, dtype="float32", attn_impl="dense", dropout=0.0)
_IDS = np.random.RandomState(0).randint(0, 64, (16, 8, 8))
N_STEPS = 10
INTERVAL = 3
CURVE_RTOL = 1e-4
_STATE = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test (restored after): the model is tiny,
    and pytest-xdist's workers would otherwise each spread it over every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def jax_model():
    prt.seed(0)
    return JaxGPT(JaxGPTConfig(**CFG))


def initial_state():
    """The JAX model's initial state dict (numpy), computed once."""
    if not _STATE:
        _STATE.update({k: np.asarray(v)
                       for k, v in jax_model().state_dict().items()})
    return _STATE


def data_fn(step):
    b = torch.from_numpy(_IDS[step % len(_IDS)])
    return (b, b)


def jax_data_fn(step):
    b = jnp.asarray(_IDS[step % len(_IDS)])
    return (b, b)


def make_ts(opt=None, dtype=None, **kw):
    """A fresh port train state from the JAX model's initial weights, as
    a relaunched process builds it."""
    model = gpt_from_jax_state_dict(GPTConfig(**CFG), initial_state(),
                                    device="cpu", dtype=dtype)
    return build_train_step(model, opt or AdamW(1e-2), gpt_loss_fn, **kw)


_REF = []


def reference_curve():
    """The uninterrupted curve (no checkpointing), computed once."""
    if not _REF:
        ts = make_ts()
        _REF.extend(float(ts.step(data_fn(s))) for s in range(N_STEPS))
    return _REF


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().copy()


def _tensors(tree):
    return {k: v for k, v in sharded._leaf_map(tree).items()}


# ---------------------------------------------------------------------------
# TrainFaultPlan and PreemptSignal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(20))
def test_plan_draws_the_jax_plan(seed):
    kw = dict(steps=10, p_kill=0.12, p_save_io=0.10, p_fetch=0.10,
              p_preempt=0.05)
    got = TrainFaultPlan.random(seed, **kw)
    want = JaxTrainFaultPlan.random(seed, **kw)
    assert [e.as_dict() for e in got.events()] == \
        [e.as_dict() for e in want.events()]
    assert got.to_dict() == want.to_dict()
    # the dumps load across the packages
    assert TrainFaultPlan.from_dict(want.to_dict()).to_dict() == \
        want.to_dict()


def test_train_fault_plan_surface():
    a = TrainFaultPlan.random(7, steps=32, p_kill=0.2, p_save_io=0.2,
                              p_fetch=0.2, p_preempt=0.1)
    b = TrainFaultPlan.random(7, steps=32, p_kill=0.2, p_save_io=0.2,
                              p_fetch=0.2, p_preempt=0.1)
    assert [e.as_dict() for e in a.events()] == \
        [e.as_dict() for e in b.events()]
    assert a.events(), "rates this high must schedule something"
    ev = a.events()[0]
    assert a.take(ev.kind, ev.step) is ev
    assert a.take(ev.kind, ev.step) is None
    assert a.fired_log() == [(ev.step, ev.kind)]
    c = TrainFaultPlan.from_dict(a.to_dict())
    assert [e.as_dict() for e in c.events()] == \
        [e.as_dict() for e in a.events()]
    assert c.seed == a.seed and c.pending == len(a.events())
    a.reset()
    assert a.pending == len(a.events()) and a.fired_log() == []
    with pytest.raises(ValueError, match="unknown train fault kind"):
        TrainFaultPlan([TrainFaultEvent(1, "replica_kill")])
    with pytest.raises(ValueError, match="duplicate"):
        TrainFaultPlan([TrainFaultEvent(1, "kill"),
                        TrainFaultEvent(1, "kill")])
    with pytest.raises(ValueError, match="not a TrainFaultPlan"):
        TrainFaultPlan.from_dict({"fault_plan": 1})


def test_preempt_signal_flag_and_sigterm():
    p = PreemptSignal()
    assert not p.is_set()
    p.set()
    assert p.is_set()
    p.clear()
    assert not p.is_set()
    p.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert p.is_set()
    finally:
        signal.signal(signal.SIGTERM, p._prev_handler)


# ---------------------------------------------------------------------------
# the capture schema
# ---------------------------------------------------------------------------
def test_capture_holds_live_state_and_fingerprint():
    ts = make_ts()
    ts.step(data_fn(0))
    cap = ts.capture()
    for name, p in ts.model.named_parameters():
        assert cap["model"][name].data_ptr() == p.data_ptr()
        st = ts.opt.state[p]
        assert cap["opt"]["slots"]["m"][name].data_ptr() == \
            st["m"].data_ptr()
    assert int(cap["step"]) == 1 and int(cap["schema"]) == 1
    assert int(cap["opt"]["step"]) == 1
    # one device, no communication schedule: the JAX fingerprint of
    # comm:none|gather:none
    import zlib
    assert int(cap["fingerprint"]) == ts.schedule_fingerprint() == \
        zlib.crc32(b"comm:none|gather:none") & 0xFFFFFFFF


def test_restore_train_state_legacy_dict(tmp_path):
    """The ``{"model", "opt"}`` dump restores the parameters and the
    optimizer's state and step count; it carries no step counter."""
    ts = make_ts()
    for s in range(3):
        ts.step(data_fn(s))
    cap = ts.capture()
    path = str(tmp_path / "legacy")
    save_sharded({"model": cap["model"], "opt": cap["opt"]}, path)
    cont = [float(ts.step(data_fn(s))) for s in range(3, 5)]

    ts2 = make_ts()
    restore_train_state(path, ts2)
    assert ts2.opt.step_count == 3
    assert [float(ts2.step(data_fn(s))) for s in range(3, 5)] == cont
    assert ts2.step_count == 2


def test_restore_mismatched_options_raises(tmp_path):
    """A checkpoint saved without a scaler does not restore into a state
    built with one."""
    ts = make_ts()
    ts.step(data_fn(0))
    path = str(tmp_path / "plain")
    save_sharded(ts.capture(), path)
    ts2 = make_ts(scaler=GradScaler(init_loss_scaling=8.0))
    with pytest.raises(ValueError, match="scaler/comm_dtype"):
        restore_train_state(path, ts2)


def test_amp_scaler_state_roundtrip(tmp_path):
    scaler = GradScaler(enable=True, init_loss_scaling=8.0,
                        incr_every_n_steps=2)
    ts = make_ts(scaler=scaler)
    for s in range(4):
        ts.step(data_fn(s))
    want_scale = float(ts.scaler_state.scale)
    want_growth = int(ts.scaler_state.growth_tracker)
    assert want_scale != 8.0
    path = str(tmp_path / "amp")
    save_sharded(ts.capture(), path)
    ts2 = make_ts(scaler=scaler)
    ts2.restore(path)
    assert float(ts2.scaler_state.scale) == want_scale
    assert int(ts2.scaler_state.growth_tracker) == want_growth
    assert ts2.step_count == 4


def test_shape_change_keeps_fresh_value_with_one_warning(tmp_path):
    ts = make_ts()
    ts.step(data_fn(0))
    cap = ts.capture()
    cap["model"] = dict(cap["model"])
    name = "embedding.position_embeddings"
    cap["model"][name] = torch.zeros(3, 5)
    path = str(tmp_path / "shape")
    save_sharded(cap, path)
    ts2 = make_ts()
    fresh = ts2.model.state_dict()[name].clone()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        restore_train_state(path, ts2)
    assert sum("different shape" in str(x.message) for x in w) == 1
    assert torch.equal(ts2.model.state_dict()[name], fresh)
    other = "head.norm.weight"
    assert torch.equal(ts2.model.state_dict()[other],
                       ts.model.state_dict()[other])


# ---------------------------------------------------------------------------
# crash consistency
# ---------------------------------------------------------------------------
def test_kill_between_save_and_commit_falls_back(tmp_path):
    """Die between the save and its commit: the step is torn (no
    manifest, no ``COMMITTED``), restore takes the previous committed
    step, and the resumed curve is the uninterrupted one bit for bit."""
    d = str(tmp_path / "run")
    ref = reference_curve()
    ts = make_ts()
    mgr = CheckpointManager(d, save_interval_steps=INTERVAL)
    loop = ResilientTrainLoop(ts, data_fn, manager=mgr, commit_lag=0)
    loop.run(3)                                    # step_3 committed
    for s in range(3, 6):
        ts.step(data_fn(s))
    mgr.save(6, ts.capture())                      # background, no commit
    mgr.abandon()                                  # simulated death

    ts2 = make_ts()
    mgr2 = CheckpointManager(d, save_interval_steps=INTERVAL)
    assert mgr2.latest_step() == 3
    assert not os.path.exists(mgr2.step_path(6))
    assert not [n for n in os.listdir(d) if "pending" in n]
    loop2 = ResilientTrainLoop(ts2, data_fn, manager=mgr2)
    res = loop2.run(N_STEPS)
    assert res.start_step == 3
    for s in range(3, N_STEPS):
        assert loop2.step_losses[s] == ref[s]


def test_manifest_detects_corrupt_step_and_falls_back(tmp_path):
    d = str(tmp_path / "run")
    mgr = CheckpointManager(d)
    for s in (2, 4):
        mgr.save(s, {"w": torch.arange(64.0) + s})
    mgr.wait()
    assert mgr.all_steps() == [2, 4]
    files = [f for f in glob.glob(mgr.step_path(4) + "/state/**/*",
                                  recursive=True) if os.path.isfile(f)]
    victim = max(files, key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, why = mgr.verify_step(4)
    assert not ok and "checksum mismatch" in why
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mgr.latest_step(verified=True) == 2
        back = mgr.restore(target={"w": torch.zeros(64)})
    assert any("failed verification" in str(x.message) for x in w)
    torch.testing.assert_close(back["w"], torch.arange(64.0) + 2)
    with pytest.raises(ValueError, match="not restorable"):
        mgr.restore(4, target={"w": torch.zeros(64)})
    mgr.close()


def test_save_io_fault_skips_checkpoint_and_reaps_orphan(tmp_path):
    """An injected save-IO failure at a boundary: that checkpoint is
    skipped, training goes on, its torn directory is reaped, a later
    boundary commits, and the curve does not move."""
    ref = reference_curve()
    plan = TrainFaultPlan([TrainFaultEvent(INTERVAL, "save_io")])
    ts = make_ts()
    loop = ResilientTrainLoop(ts, data_fn, str(tmp_path / "run"),
                              save_interval_steps=INTERVAL, chaos=plan)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = loop.run(N_STEPS)
    assert res.status == "complete"
    assert plan.fired_log() == [(INTERVAL, "save_io")]
    assert any("save for step_3 failed" in str(x.message) for x in w)
    assert not os.path.exists(loop.manager.step_path(INTERVAL))
    assert not [n for n in os.listdir(loop.manager.directory)
                if "pending" in n]
    assert 2 * INTERVAL in loop.manager.all_steps()
    assert [loop.step_losses[s] for s in range(N_STEPS)] == ref


def test_preempt_signal_saves_out_of_interval_and_resumes(tmp_path):
    """A preempt at a step off the interval saves synchronously and exits
    "preempted"; the relaunched loop resumes from that step, bit for
    bit."""
    ref = reference_curve()
    plan = TrainFaultPlan([TrainFaultEvent(5, "preempt_signal")])
    loop = ResilientTrainLoop(make_ts(), data_fn, str(tmp_path / "run"),
                              save_interval_steps=INTERVAL, chaos=plan)
    res = loop.run(N_STEPS)
    assert res.status == "preempted" and res.next_step == 5
    assert loop.manager.latest_step(verified=True) == 5

    loop2 = ResilientTrainLoop(make_ts(), data_fn, str(tmp_path / "run"),
                               save_interval_steps=INTERVAL)
    res2 = loop2.run(N_STEPS)
    assert res2.status == "complete" and res2.start_step == 5
    full = dict(loop.step_losses)
    full.update(loop2.step_losses)
    assert [full[s] for s in range(N_STEPS)] == ref


def test_manual_preempt_flag(tmp_path):
    loop = ResilientTrainLoop(make_ts(), data_fn, str(tmp_path / "run"),
                              save_interval_steps=INTERVAL)
    loop.preempt.set()
    res = loop.run(N_STEPS)
    assert res.status == "preempted" and res.next_step == 0
    assert res.losses == []


def test_fetch_fault_retries_without_perturbing_curve(tmp_path):
    ref = reference_curve()
    plan = TrainFaultPlan([TrainFaultEvent(2, "fetch"),
                           TrainFaultEvent(7, "fetch")])
    loop = ResilientTrainLoop(make_ts(), data_fn, str(tmp_path / "run"),
                              save_interval_steps=INTERVAL, chaos=plan)
    res = loop.run(N_STEPS)
    assert res.status == "complete"
    assert [loop.step_losses[s] for s in range(N_STEPS)] == ref
    assert plan.fired_log() == [(2, "fetch"), (7, "fetch")]


def test_persistent_fetch_failure_surfaces(tmp_path):
    class Broken(float):
        def __float__(self):
            raise RuntimeError("device lost")

    ts = make_ts()
    step = ts.step
    ts.step = lambda batch, rng=None: (step(batch, rng), Broken())[1]
    loop = ResilientTrainLoop(ts, data_fn, str(tmp_path / "run"),
                              save_interval_steps=INTERVAL, fetch_retries=2)
    with pytest.raises(RuntimeError, match="device lost"):
        loop.run(N_STEPS)


def test_held_writer_keeps_the_saved_step(tmp_path, monkeypatch):
    """The optimizer writes the parameters and its state in place: a save
    whose writer is held until after the next step still writes the
    saved step's state (the save snapshots the tree before it
    returns)."""
    ts = make_ts()
    for s in range(3):
        ts.step(data_fn(s))
    want = {k: _bits(t) for k, t in _tensors(ts.capture()).items()}
    gate, started = threading.Event(), threading.Event()
    write = sharded._Snapshot.write

    def held(self, path, force):
        started.set()
        assert gate.wait(60)
        return write(self, path, force)
    monkeypatch.setattr(sharded._Snapshot, "write", held)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(3, ts.capture(), fence=ts.fence_writes)
    assert started.wait(60)
    after = float(ts.step(data_fn(3)))
    moved = {k: _bits(t) for k, t in _tensors(ts.capture()).items()}
    assert any(not np.array_equal(moved[k], want[k]) for k in want)
    gate.set()
    mgr.wait()
    ts2 = make_ts()
    restore_train_state(os.path.join(mgr.step_path(3), "state"), ts2)
    got = {k: _bits(t) for k, t in _tensors(ts2.capture()).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert float(ts2.step(data_fn(3))) == after


@pytest.mark.parametrize("master_weights", [True, False])
def test_memory_efficient_int8_offload_scaler_resume(tmp_path,
                                                     master_weights):
    """``MemoryEfficientAdamW`` with int8 moments -- with float32 masters,
    or without (stochastic rounding keyed on the step) -- and offloaded
    state, under a ``GradScaler``: a resume from a capture continues bit
    for bit (losses, parameters, codes, scales, masters, the scaler)."""
    def make():
        opt = MemoryEfficientAdamW(1e-2, moment_dtype="int8", block_size=64,
                                   master_weights=master_weights)
        return make_ts(opt, dtype=torch.bfloat16, offload_opt_state=True,
                       scaler=GradScaler(init_loss_scaling=2.0 ** 10,
                                         incr_every_n_steps=2))
    ts = make()
    for s in range(3):
        ts.step(data_fn(s))
    cap = ts.capture()
    assert isinstance(cap["opt"]["slots"]["m"]["blocks.0.mlp.fc1.weight"],
                      dict)
    assert bool(cap["opt"]["master"]) == master_weights
    path = str(tmp_path / "me")
    save_sharded(cap, path)
    cont = [float(ts.step(data_fn(s))) for s in (3, 4)]

    ts2 = make()
    ts2.restore(path)
    assert ts2.step_count == 3 and ts2.opt.step_count == 3
    assert [float(ts2.step(data_fn(s))) for s in (3, 4)] == cont
    a, b = _tensors(ts.capture()), _tensors(ts2.capture())
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(_bits(a[k]), _bits(b[k])), k


# ---------------------------------------------------------------------------
# the port against the JAX loop
# ---------------------------------------------------------------------------
def test_uninterrupted_curve_matches_jax_loop(tmp_path, one_device_topology):
    """Five AdamW(1e-2) steps of both loops from the same weights and
    data, each saving every third step."""
    jts = jax_build_train_step(jax_model(), jax_optim.AdamW(1e-2),
                               jax_gpt_loss_fn, topo=one_device_topology)
    jloop = JaxResilientTrainLoop(jts, jax_data_fn, str(tmp_path / "jax"),
                                  save_interval_steps=INTERVAL,
                                  telemetry=False)
    jloop.run(5)
    loop = ResilientTrainLoop(make_ts(), data_fn, str(tmp_path / "port"),
                              save_interval_steps=INTERVAL)
    loop.run(5)
    want = [jloop.step_losses[s] for s in range(5)]
    got = [loop.step_losses[s] for s in range(5)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    assert loop.manager.all_steps() == jloop.manager.all_steps() == [3]


def test_jax_capture_goes_on_in_the_port(one_device_topology):
    """Three JAX steps, ``jax.device_get(ts.capture())`` carried into a
    port train state: the port's next two steps are the JAX curve's."""
    jts = jax_build_train_step(jax_model(), jax_optim.AdamW(1e-2),
                               jax_gpt_loss_fn, topo=one_device_topology)
    for s in range(3):
        jts.step(jax_data_fn(s))
    cap = jax.device_get(jts.capture())
    want = [float(jts.step(jax_data_fn(s))) for s in (3, 4)]
    ts = train_state_from_jax_capture(make_ts(), cap)
    assert ts.step_count == 3 and ts.opt.step_count == 3
    got = [float(ts.step(data_fn(s))) for s in (3, 4)]
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    np.testing.assert_allclose(got, reference_curve()[3:5],
                               rtol=CURVE_RTOL)


# ---------------------------------------------------------------------------
# the 20-seed kill-anywhere property
# ---------------------------------------------------------------------------
_RESULTS = {}


def _plan(seed):
    plan = TrainFaultPlan.random(seed, steps=N_STEPS, p_kill=0.12,
                                 p_save_io=0.10, p_fetch=0.10,
                                 p_preempt=0.05)
    if not plan.events():
        # a seed that drew nothing still exercises a mid-run kill
        plan = TrainFaultPlan([TrainFaultEvent(seed % (N_STEPS - 1) + 1,
                                               "kill")], seed=seed)
    return plan


def _run_to_completion(directory, plan, max_lives=14):
    """The relaunch harness: each life builds its state afresh (a dead
    process shares nothing with its successor but the checkpoint
    directory and the fault schedule), runs, and is relaunched on a kill
    or a preemption until the run completes."""
    curve, lives = {}, 0
    while True:
        lives += 1
        assert lives <= max_lives, "relaunch loop did not converge"
        loop = ResilientTrainLoop(make_ts(), data_fn, directory,
                                  save_interval_steps=INTERVAL,
                                  chaos=plan, fetch_retries=2)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = loop.run(N_STEPS)
        except ChaosKill:
            curve.update(loop.step_losses)
            continue
        curve.update(loop.step_losses)
        if res.status == "preempted":
            continue
        assert res.status == "complete"
        return curve, lives


def _seed_result(seed, directory):
    """(curve, lives, plan) of one seed, computed once a process."""
    if seed not in _RESULTS:
        plan = _plan(seed)
        curve, lives = _run_to_completion(directory, plan)
        _RESULTS[seed] = (curve, lives, plan)
    return _RESULTS[seed]


@pytest.mark.parametrize("seed", range(20))
def test_kill_anywhere_bit_identical(seed, tmp_path):
    """A random fault schedule (kills, kills inside the overlapped-save
    window among them, save-IO failures, fetch failures, preempt exits);
    relaunch until complete; the curve assembled across lives equals the
    uninterrupted one bit for bit."""
    curve, lives, plan = _seed_result(seed, str(tmp_path / "run"))
    ref = reference_curve()
    assert sorted(curve) == list(range(N_STEPS))
    for s in range(N_STEPS):
        assert curve[s] == ref[s], (
            f"seed {seed}: resumed loss diverged at step {s}: "
            f"{curve[s]!r} != {ref[s]!r}; fired={plan.fired_log()}")
    n_relaunch = sum(1 for e in plan.events()
                     if e.kind in ("kill", "preempt_signal"))
    assert lives <= n_relaunch + 1


def test_zz_kill_anywhere_suite_floor(tmp_path):
    """The property stays adversarial: across the 20 seeds enough faults
    fired and enough relaunches happened.  Seeds another worker ran are
    run again here, so the floor holds under any test distribution."""
    fired = extra = 0
    for seed in range(20):
        _, lives, plan = _seed_result(seed, str(tmp_path / f"run{seed}"))
        fired += len(plan.fired_log())
        extra += lives - 1
    assert fired >= 20, (fired, extra)
    assert extra >= 8, (fired, extra)


# ---------------------------------------------------------------------------
# graftlint chaos-hook over the port's train hooks
# ---------------------------------------------------------------------------
def test_chaos_hook_covers_port_train_loop_and_manager():
    """Tier A ``chaos-hook`` scans the port's loop, plan and manager
    clean: with ``chaos=None`` every hook site is a guarded no-op."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from graftlint.core import SourceFile, parse_suppressions
    from graftlint.passes import chaos_hook

    def scan(src, path):
        return chaos_hook.run(SourceFile(
            path=path, source=src, tree=ast.parse(src),
            suppressions=parse_suppressions(src)))

    pkg = os.path.join(REPO, "paddle_ray_tpu_torch")
    for rel in ("train/loop.py", "train/chaos.py", "checkpoint/manager.py"):
        with open(os.path.join(pkg, rel)) as f:
            src = f.read()
        assert scan(src, rel) == [], f"unguarded chaos hook in {rel}"
    # the pass does flag an unguarded consult of the loop's kind
    assert len(scan("class L:\n"
                    "    def run(self, n):\n"
                    "        self.chaos.take('kill', 1)\n",
                    "train/loop.py")) == 1
