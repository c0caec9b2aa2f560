"""The roofline table of the registry cells on a 16 x 16 pod of H100s,
from the port's dry-run records (`launch.dryrun`) and the analytic model:
the counterpart of the JAX package's `launch/roofline_report.py`.

LM rows take `roofline_analytic.lm_analytic` at 256 cards, 16 of them
data parallel, and "useful MF / counted" is `roofline.model_flops` per
card over the FLOPs that model counts, as the reference computes it.
The other rows take the dry run's terms (`roofline.roofline_terms` of
the traced FLOPs, bytes and collective bytes).  Every number is modelled
at H100 SXM peaks, none is measured.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dryrun results/dryrun_torch] [--out results/roofline_table_torch.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.configs import registry as R
from repro_torch.launch.roofline import model_flops
from repro_torch.launch.roofline_analytic import lm_analytic

POD_CHIPS, POD_DATA = 256, 16


def build_rows(dryrun_dir: str = "results/dryrun_torch") -> List[Dict]:
    """One row per cell whose pod record is ok."""
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*pod_16x16.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if not rec.get("ok"):
            continue
        arch, shape = rec["arch"], rec["shape"]
        spec = R.shapes_of(arch)[shape]
        if R.family_of(arch) == "lm":
            t = lm_analytic(R.ARCHS[arch], spec.step, spec.dims, n_chips=POD_CHIPS,
                            data_par=POD_DATA)
            useful = model_flops(arch, spec.dims, spec.step) / POD_CHIPS / t["flops_per_device"]
            src = "analytic"
        else:
            r = rec["roofline"]
            t = {k: r[k] for k in ("compute_s", "memory_s", "collective_s", "bottleneck")}
            dom = max(t["compute_s"], t["memory_s"], t["collective_s"])
            t["roofline_fraction"] = t["compute_s"] / dom if dom else 0.0
            useful = float("nan")
            src = "traced"
        rows.append({
            "arch": arch, "shape": shape, "src": src,
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"], "bottleneck": t["bottleneck"],
            "fraction": t.get("roofline_fraction", float("nan")), "useful": useful,
            "traced_flops": rec["flops_per_device"], "traced_bytes": rec["bytes_per_device"],
            "traced_coll": rec["collectives"]["total_bytes"],
            "temp_gb": rec["memory"]["temp_size"] / 1e9,
            "is": "modelled at H100 SXM peaks"})
    return rows


def markdown(rows) -> str:
    out = ["| arch | shape | src | compute s | memory s | collective s | bottleneck | "
           "useful MF / counted |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        u = f"{r['useful']:.2f}" if r["useful"] == r["useful"] else "—"
        out.append(f"| {r['arch']} | {r['shape']} | {r['src']} | {r['compute_s']:.3e} | "
                   f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['bottleneck']} | "
                   f"{u} |")
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_table_torch.json")
    args = ap.parse_args(argv)
    rows = build_rows(args.dryrun)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    table = markdown(rows)
    print("(modelled at H100 SXM peaks: 989 TFLOP/s bf16, 3.35 TB/s HBM3, 900 GB/s NVLink)")
    print(table)
    return table


if __name__ == "__main__":
    main()
