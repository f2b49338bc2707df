"""Where a serving step's time goes in the PyTorch port, on one CUDA card.

Serves the workload of ``chip_smoke.py`` (GPT-3 350m, bf16, random
weights from seed 0; ``bench.py:bench_serving``'s 12 mixed-length
requests) with the port's ``ServingEngine``: one warm-up run to drain
(its step-time percentiles), then two more, over the same two windows of
steps -- the first steps (prefill chunks beside decode rows) and the
steps after every prompt has been prefilled (decode only) -- one timed
with the host clock, one under ``torch.profiler`` (whose own host cost
inflates wall time).  For each window it prints one JSON line: wall ms
per step (unprofiled), device kernel ms per step (profiled), the device's
idle share of the step, and the kernels with the most device time.

With ``async_ab`` it instead serves the workload with the engine's
``async_dispatch`` off and on in one process, in the order off, on, on,
off, off, on (after one warm-up run), over a bf16 pool and over an int8
pool with every other request sampled as ``chip_smoke.py``'s
``serve_async`` does, and prints each run's decode tokens/s, p50 / p99
step ms and wall seconds, then each mode's mean.

Run from the repository root::

    python3 tools/torch_serve_profile.py
    python3 tools/torch_serve_profile.py async_ab
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_ray_tpu_torch.models import build_gpt  # noqa: E402
from paddle_ray_tpu_torch.serving import ServingEngine  # noqa: E402

WINDOW = 20


def _engine(model, **kw):
    eng = ServingEngine(model, page_size=cs.PAGE, max_batch=cs.MAX_BATCH,
                        **kw)
    r = np.random.RandomState(1)
    sampled = kw.get("kv_cache_dtype") == "int8"
    for i, (t0, n) in enumerate(
            cs.bench_serving_workload(model.cfg.max_seq_len)):
        skw = dict(cs.SAMPLED, seed=1000 + i) if sampled and i % 2 else {}
        eng.submit(r.randint(0, model.cfg.vocab_size, (t0,)), n, **skw)
    return eng


def async_ab(model) -> None:
    """Sync and async dispatch over the same workload, alternated."""
    for kv in ("model", "int8"):
        _engine(model, kv_cache_dtype=kv).run()          # warm-up
        runs = {False: [], True: []}
        for mode in (False, True, True, False, False, True):
            eng = _engine(model, kv_cache_dtype=kv, async_dispatch=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            st = eng.stats.to_dict()
            row = {"kv_cache_dtype": kv, "async_dispatch": mode,
                   "wall_s": round(time.perf_counter() - t0, 3),
                   **{k: st[k] for k in ("decode_tokens_per_s",
                                         "p50_token_ms", "p99_token_ms",
                                         "mixed_steps")}}
            runs[mode].append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({"kv_cache_dtype": kv, "mean": {
            ("async" if mode else "sync"): {
                k: round(float(np.mean([r[k] for r in rs])), 3)
                for k in ("decode_tokens_per_s", "p50_token_ms", "wall_s")}
            for mode, rs in runs.items()}}), flush=True)


def _windows(model, profiled: bool):
    """Serve the workload, timing (or profiling) two windows of WINDOW
    steps: the first steps, and the first steps after every prompt has
    been prefilled.  Scheduling is deterministic, so the profiled and the
    unprofiled drive cover the same steps.  Returns {window: result}."""
    eng = _engine(model)
    out = {}
    for name in ("first_steps_mixed", "decode_only"):
        if name == "decode_only":
            while eng.pending or any(s is not None and s.prefilling
                                     for s in eng._slots):
                eng.step()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        torch.cuda.synchronize()
        with ctx as prof:
            t0 = time.perf_counter()
            for _ in range(WINDOW):
                eng.step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        out[name] = {"wall_ms_per_step": 1e3 * wall_s / WINDOW,
                     "active_slots": eng.active,
                     "rows": cs.kernel_rows(prof) if profiled else None}
    eng.run()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: no CUDA card")
    smi = cs.phase_device()
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    model = build_gpt(cs.MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    if sys.argv[1:] == ["async_ab"]:
        async_ab(model)
        print(smi, flush=True)
        return
    eng = _engine(model)                # warm-up run: the whole workload
    t0 = time.perf_counter()
    eng.run()
    st = eng.stats.to_dict()
    print(json.dumps({"window": "whole_run", "wall_s": round(
        time.perf_counter() - t0, 3), **{k: st[k] for k in (
            "mixed_steps", "p50_token_ms", "p99_token_ms",
            "decode_tokens_per_s", "prefill_tokens_per_s")}}), flush=True)
    del eng
    plain = _windows(model, profiled=False)
    traced = _windows(model, profiled=True)
    for name, w in traced.items():
        rows = w["rows"]
        device_ms = sum(t for _, t, _ in rows) / 1e3 / WINDOW
        wall_ms = plain[name]["wall_ms_per_step"]
        top = sorted(rows, key=lambda r: -r[1])[:8]
        print(json.dumps({
            "window": name, "steps": WINDOW,
            "active_slots": plain[name]["active_slots"],
            "wall_ms_per_step": round(wall_ms, 3),
            "wall_ms_per_step_profiled": round(w["wall_ms_per_step"], 3),
            "device_ms_per_step": round(device_ms, 3),
            "device_idle_share": round(1.0 - device_ms / wall_ms, 4),
            "top_kernels": [{"name": k[:90], "ms_per_step":
                             round(t / 1e3 / WINDOW, 4),
                             "calls_per_step": c / WINDOW}
                            for k, t, c in top]}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
