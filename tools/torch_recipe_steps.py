"""Where the GPT pretraining recipe's step time goes: gpt3-350m (bf16,
flash, batch 8 x 1024) trained with the options of ``chip_smoke.py``'s
``train_recipe`` added one at a time, from ``train``'s plain step up to
the whole recipe.

Each configuration builds the model from the same seed, runs 2 warm-up
and 4 timed steps (host clock around synchronised steps: ``step_ms``),
then one step under ``torch.profiler`` (``chip_smoke.profiled``: the
device time of its kernels, their count and the idle share).  The
configurations, each adding to the one before:

* ``plain``: remat off, no dropout, ``AdamW(1e-4)`` (``train``);
* ``dropout``: dropout 0.1 under a step key (49 dropout launches forward,
  49 backward);
* ``remat_none``: every block under ``torch.utils.checkpoint``;
* ``remat_dots``: the ``"dots"`` selective-checkpoint policy;
* ``ce_chunk``: chunked cross-entropy (256 positions a chunk);
* ``optimizer``: the recipe's schedule, ``beta2=0.95``, decay 0.1 and the
  global-norm clip;
* ``grad_accum``: two micro-batches a step (the whole recipe);
* ``remat_dots_attn``: the recipe with ``"dots_attn"``.

Prints one JSON line per configuration and the card's name and power
limit.  Run from the repository root on a machine with a CUDA card::

    python3 tools/torch_recipe_steps.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

STEPS, WARMUP = 4, 2

CONFIGS = (
    ("plain", dict(remat=False), False, 1),
    ("dropout", dict(remat=False, dropout=0.1), False, 1),
    ("remat_none", dict(dropout=0.1, remat=True, remat_policy="none"),
     False, 1),
    ("remat_dots", dict(dropout=0.1, remat=True, remat_policy="dots"),
     False, 1),
    ("ce_chunk", dict(chip_smoke.RECIPE_CFG), False, 1),
    ("optimizer", dict(chip_smoke.RECIPE_CFG), True, 1),
    ("grad_accum", dict(chip_smoke.RECIPE_CFG), True,
     chip_smoke.RECIPE_ACCUM),
    ("remat_dots_attn", dict(chip_smoke.RECIPE_CFG,
                             remat_policy="dots_attn"), True,
     chip_smoke.RECIPE_ACCUM),
)


def run(name, cfg, recipe_opt, accum) -> dict:
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED)
    model = build_gpt(chip_smoke.MODEL, device="cuda", dtype=torch.bfloat16,
                      attn_impl="flash", max_seq_len=chip_smoke.TRAIN_SEQ,
                      generator=g, **cfg)
    opt = (chip_smoke._recipe_optimizer() if recipe_opt
           else AdamW(chip_smoke.TRAIN_LR))
    ts = build_train_step(model, opt, gpt_loss_fn, grad_accum=accum)
    ids = torch.from_numpy(np.random.RandomState(chip_smoke.SEED).randint(
        0, model.cfg.vocab_size,
        (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ))).to("cuda")
    key = prng.PRNGKey(chip_smoke.SEED)

    def step(i=0):
        return ts.step((ids, ids), prng.fold_in(key, i)
                       if model.cfg.dropout > 0 else None)
    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(WARMUP + i) for i in range(STEPS)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    _, rows, attempts = chip_smoke.profiled(step)
    device_ms = sum(t for _, t, _ in rows) / 1e3
    out = {"config": name, "step_ms": step_ms, "device_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / step_ms,
           "kernels_launched": sum(c for _, _, c in rows),
           "dropout_ms": sum(t for k, t, _ in rows
                             if "dropout_kernel" in k) / 1e3,
           "flash_ms": sum(t for k, t, _ in rows if "flash_" in k) / 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "losses": [float(x) for x in losses],
           "profile_attempts": attempts}
    print(json.dumps(out), flush=True)
    del ts, model, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_recipe_steps: no CUDA card")
    from paddle_ray_tpu_torch.ops import _build
    _build.build_all(["dropout", "flash_attention"])
    for name, cfg, recipe_opt, accum in CONFIGS:
        run(name, cfg, recipe_opt, accum)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
