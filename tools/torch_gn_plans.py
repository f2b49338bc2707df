"""Time the fused GroupNorm kernels of ``paddle_ray_tpu_torch`` at other
plans than ``group_norm_plan``'s, at the SD-UNet training step's bf16
cases (batch 32): the evidence behind the plan's rules.

For each (rows, C, mode) of the step and each kernel (forward, backward)
it times, with ``chip_smoke.time_ms`` (median of 20, L2 flushed):

* ``plan``: the plan the wrappers launch;
* ``w16_pair`` / ``w32_pair``: the fewest groups a group-set whose width is
  a multiple of 16 / 32 bytes, at the smallest cluster whose blocks fit two
  to an SM (``GN_SMEM_PAIR``), one block a cluster where the slice allows;
* ``w16_k2x`` / ``w32_k2x``: the same group-sets at twice that cluster
  (up to 16 blocks);
* ``rowwise``: the rowwise route (one block per (sample, group)).

Each line gives ``[groups a set, blocks a cluster, ms]``; the last line sums each policy over the step's 56 calls
(a policy without a plan at some case takes that case's plan).  Run from
the repository root on a machine with a CUDA card::

    python3 tools/torch_gn_plans.py
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _launch(gn, kind, x, w, b, s, t, dy, mu, rs, groups, act, plan_args):
    """One launch of the kernel of ``kind`` with the C entry's plan
    arguments (``groupnorm._plan_args``)."""
    import torch
    n, rows, c = x.shape
    dts = (gn._KERNEL_DTYPES[x.dtype], gn._KERNEL_DTYPES[w.dtype],
           gn._KERNEL_DTYPES[s.dtype] if s is not None else 0)
    if kind == "fwd":
        y = torch.empty_like(x)
        m = torch.empty(n, groups, device=x.device)
        r = torch.empty_like(m)
        gn._launch("fused_group_norm", "prt_group_norm_fwd", x.device,
                   x.data_ptr(), w.data_ptr(), b.data_ptr(), gn._ptr(s),
                   gn._ptr(t), y.data_ptr(), m.data_ptr(), r.data_ptr(), n,
                   rows, c, groups, 1e-5, gn._ACTS[act], *dts, *plan_args)
        return y
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    parts, dw_db = torch.empty(2, n, c, **f32), torch.empty(2, c, **f32)
    ds_dt = torch.empty(2, n, c, **f32) if s is not None else None
    gn._launch("fused_group_norm_bwd", "prt_group_norm_bwd", x.device,
               x.data_ptr(), w.data_ptr(), b.data_ptr(), gn._ptr(s),
               gn._ptr(t), mu.data_ptr(), rs.data_ptr(), dy.data_ptr(),
               dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
               None if ds_dt is None else ds_dt[0].data_ptr(),
               None if ds_dt is None else ds_dt[1].data_ptr(),
               dw_db[0].data_ptr(), dw_db[1].data_ptr(), n, rows, c, groups,
               gn._ACTS[act], *dts, *plan_args)
    return dx


def _alternatives(gn, rows, c, groups, itemsize, bwd):
    """{policy: plan} for the 16- and 32-byte group-sets at the smallest
    cluster fitting two blocks an SM, and at twice it, built by
    ``group_norm_plan``'s own helpers."""
    cpg = c // groups
    out = {}
    for align in (16, 32):
        g = gn._fewest_groups(groups, cpg, itemsize, align)
        if g is None:
            continue
        k = next((k for k in range(1, gn.GN_CLUSTER_MAX + 1)
                  if gn._cluster_plan(rows, cpg, itemsize, bwd, g,
                                      k).smem_bytes <= gn.GN_SMEM_PAIR),
                 None)
        if k is None:
            continue
        out[f"w{align}_pair"] = gn._cluster_plan(rows, cpg, itemsize, bwd,
                                                 g, k)
        if 1 < 2 * k <= gn.GN_CLUSTER_MAX:
            out[f"w{align}_k2x"] = gn._cluster_plan(rows, cpg, itemsize, bwd,
                                                    g, 2 * k)
    return out


def main() -> None:
    import torch
    import chip_smoke as cs
    from paddle_ray_tpu_torch.ops import groupnorm as gn
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_plans: no CUDA card")
    bf16, n, groups = torch.bfloat16, cs.UNET_BATCH, cs.UNET_CFG["groups"]
    calls = cs.unet_gn_calls()
    sums = collections.Counter()
    for rows, c, mode in sorted(set(calls), key=lambda k: (-k[0], k[1], k[2])):
        act, mod = cs.GN_MODES[mode]
        x, w, b, s, t, dy = cs._gn_inputs(n, rows, c, mod, bf16)
        _, mu, rs = gn.fused_group_norm_fwd(x, w, b, s, t, groups=groups,
                                            act=act)
        count = calls.count((rows, c, mode))
        for kind in ("fwd", "bwd"):
            policies = {"plan": gn.group_norm_plan(n, rows, c, groups, bf16,
                                                   kind),
                        **_alternatives(gn, rows, c, groups, 2,
                                        kind == "bwd")}
            row = {}
            for name, plan in policies.items():
                args = gn._plan_args(plan, x, dy)
                ms = cs.time_ms(lambda: _launch(gn, kind, x, w, b, s, t, dy,
                                                mu, rs, groups, act, args))
                row[name] = [plan.groups_per_set, plan.cluster, ms]
            row["rowwise"] = [0, 0, cs.time_ms(lambda: _launch(
                gn, kind, x, w, b, s, t, dy, mu, rs, groups, act,
                (0,) * 6))]
            for name in ("plan", "w16_pair", "w32_pair", "w16_k2x",
                         "w32_k2x", "rowwise"):
                sums[f"{kind}_{name}"] += count * row.get(
                    name, row["plan"])[2]
            sums[f"{kind}_best"] += count * min(v[2] for v in row.values())
            print(json.dumps({"case": f"{rows}x{c}_{mode}", "kind": kind,
                              "calls": count, **row}), flush=True)
        del x, dy, mu, rs
    print(json.dumps({"step_sums_ms": dict(sums)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
