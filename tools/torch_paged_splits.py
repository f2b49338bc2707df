"""The paged kernel's split-K and tile-path choices over an int8 pool and
a bf16 one, measured on one card with ``chip_smoke.time_ms`` (median of
30, L2 flushed):

* splits: at four of ``chip_smoke.paged_cases``' cases of each pool kind
  (GPT-3 350m's 8 x 2048 decode, the long ragged decode of 1-8192 tokens,
  the 128-wide mixed chunk, GQA 4 over pages of 32) the kernel is timed at
  1, 2, 4, 8 and 16 splits of equal page runs (``kernel_plan`` forced)
  beside the plan ``kernel_plan`` picks;
* tile path: the 8 x 2048 decode with 16, 8 and 4 kv heads (a tile of one,
  two and four live pairs) and the long ragged decode, over each pool
  kind, timed with the kernel as built and with two copies of its source
  rebuilt with both thresholds (``kTcMinPairsQ8``, ``kTcMinPairsBf16``) at
  0 (every bf16 tile on the tensor cores) and 4 (every decode tile on the
  CUDA cores); each copy's result is held to the plain version at
  ``chip_smoke``'s bf16 tolerances.

Prints one JSON line per case and the card's name and power limit.  Run
from the repository root on a machine with a CUDA card::

    python3 tools/torch_paged_splits.py
"""
from __future__ import annotations

import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_CASES = ("decode_2048_q8_bf16", "long_decode_q8_bf16", "mixed_q8_bf16",
               "decode_gqa4_q8_page32_bf16", "decode_2048_bf16",
               "long_decode_bf16", "mixed_bf16", "decode_gqa4_page32_bf16")
# (name, case of paged_cases, kv heads) of the tile-path comparison
PATH_CASES = tuple(
    (f"decode_2048{g}{q8}_bf16", f"decode_2048{q8}_bf16", h_kv)
    for q8 in ("_q8", "") for g, h_kv in (("", 16), ("_gqa2", 8),
                                          ("_gqa4", 4))) + (
    ("long_decode_q8_bf16", "long_decode_q8_bf16", 16),
    ("long_decode_bf16", "long_decode_bf16", 16))
# the source's thresholds, both rebuilt as: every bf16 tile on the tensor
# cores, every decode tile on the CUDA cores
VARIANTS = {"tensor_cores": 0, "cuda_cores": 4}
THRESHOLD = re.compile(r"constexpr int (kTcMinPairs(?:Q8|Bf16)) = \d+;")


def _variant_libs(tmp: str) -> dict:
    """Copies of the paged kernel source with other thresholds, built
    together (one ``nvcc`` each) into ``tmp`` and loaded."""
    from paddle_ray_tpu_torch.ops import _build
    with open(_build.csrc_path("paged_attention")) as f:
        src = f.read()
    if len(THRESHOLD.findall(src)) != 2:
        raise SystemExit("the two kTcMinPairs constants not found in "
                         "paged_attention.cu")
    jobs = {}
    for name, pairs in VARIANTS.items():
        cu = os.path.join(tmp, f"paged_{name}.cu")
        with open(cu, "w") as f:
            f.write(THRESHOLD.sub(rf"constexpr int \1 = {pairs};", src))
        so = cu[:-3] + ".so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} copy:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from paddle_ray_tpu_torch.ops import _build
    pa = importlib.import_module("paddle_ray_tpu_torch.ops.paged_attention")
    cases = dict(chip_smoke.paged_cases())
    plan = pa.kernel_plan

    def call(c):
        host = c["lengths"].tolist()   # once: no copy inside a timed call
        return lambda: pa.paged_ragged_attention(
            c["q"], c["pool"], c["table"], c["lengths"], c["q_lens"],
            scale=1.0 / c["q"].shape[-1] ** 0.5, host_lengths=host)

    for name in SPLIT_CASES:
        c = chip_smoke._attention_case(name, **cases[name])
        host, page = c["lengths"].tolist(), c["pool"][0].shape[1]
        row = {"case": name, "plan": plan(c["q"], c["pool"], c["table"],
                                          host)}
        longest = max(-(-n // page) for n in host)
        for want in (1, 2, 4, 8, 16):
            pps = -(-longest // want)
            n = -(-longest // pps)
            pa.kernel_plan = lambda *a, n=n, pps=pps: (n, pps)
            try:
                row[f"splits_{n}"] = chip_smoke.time_ms(call(c), iters=30)
            finally:
                pa.kernel_plan = plan
        print(json.dumps(row), flush=True)

    tmp = tempfile.mkdtemp(prefix="paged_variants_")
    try:
        libs = {"built": pa._kernel_lib(), **_variant_libs(tmp)}
        for name, base, h_kv in PATH_CASES:
            c = chip_smoke._attention_case(name, **dict(cases[base],
                                                        h_kv=h_kv))
            fn = call(c)
            want = pa.paged_ragged_attention_plain(
                c["q"], c["pool"], c["table"], c["lengths"], c["q_lens"],
                scale=1.0 / c["q"].shape[-1] ** 0.5)
            row = {"case": name, "h_kv": h_kv,
                   "live_pairs": c["q"].shape[2] // h_kv}
            for variant, lib in libs.items():
                _build._LOADED["paged_attention"] = lib
                got = fn()
                err = float((got.float() - want.float()).abs().max())
                rel = chip_smoke._row_rel_err(got, want)
                if not (err <= chip_smoke.TOL[torch.bfloat16]
                        and rel <= chip_smoke.PAGED_BF16_REL_TOL):
                    raise SystemExit(f"{name} {variant}: max_abs_err {err}, "
                                     f"a row's max|err| / max|ref| {rel}")
                row[variant] = {"ms": chip_smoke.time_ms(fn, iters=30),
                                "max_abs_err": err, "row_rel_err": rel}
            _build._LOADED["paged_attention"] = libs["built"]
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
