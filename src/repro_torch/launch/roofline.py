"""Roofline analysis over the dry-run records, the counterpart of the JAX
package's ``launch/roofline.py``.

Three terms per (arch x shape x mesh) cell, all in seconds per step:

  compute    = traced FLOPs per device            / 989e12   (bf16 dense)
  memory     = op-boundary bytes per device       / 3.35e12  (HBM3)
  collective = collective wire bytes per device   / 450e9    (NVLink, one direction)

The constants are the NVIDIA H100 SXM5 datasheet peaks, not measurements:
the card's dense bf16 tensor-core rate, its HBM3 bandwidth, and its NVLink
bandwidth per direction.  FLOPs and collective bytes come from the traced
step (``launch.trace_analysis``).  The memory term uses eager op-boundary
traffic, an UPPER bound on HBM traffic (fused kernels keep their operands
on chip), flagged as such in the report.  The roofline fraction reported
is compute / max(terms).

  python -m repro_torch.launch.roofline [--markdown] [--multi-pod] [--all-meshes]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s (H100 SXM5 datasheet)
HBM_BW = 3.35e12          # HBM3 bytes/s (H100 SXM5 datasheet)
LINK_BW = 450e9           # NVLink bytes/s per direction (H100 SXM5 datasheet)
HBM_BYTES = 80 * 2**30    # device memory

OUT_DIR = os.path.join(os.path.dirname(__file__), "out", "dryrun")


def model_flops_per_device(rec: dict) -> float:
    """6*N_active*D (train) or 2*N_active*D (inference fwd), per device."""
    m = rec.get("model")
    if not m:
        return 0.0
    n_act = m["active_params"]
    kind = rec.get("kind", "train")
    B = rec.get("global_batch", 0)
    S = rec.get("seq_len", 0)
    ndev = rec["n_devices"]
    if kind == "train":
        return 6.0 * n_act * B * S / ndev
    if kind == "prefill":
        return 2.0 * n_act * B * S / ndev
    if kind == "decode":
        return 2.0 * n_act * B / ndev
    return 0.0


def load_cells(multi_pod: bool | None = None, out_dir: str = OUT_DIR) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if multi_pod is not None and rec.get("multi_pod") != multi_pod:
            continue
        cells.append(rec)
    return cells


def analyze(rec: dict) -> dict:
    if rec["status"] != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "multi_pod": rec["multi_pod"], "status": rec["status"],
                "reason": rec.get("reason", rec.get("error", ""))[:90]}
    c = rec["cost"]
    coll = rec["collectives"]
    t_compute = c["flops_per_device"] / PEAK_FLOPS
    t_memory = c["bytes_accessed_per_device"] / HBM_BW
    t_coll = coll["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    useful = mf / max(c["flops_per_device"], 1e-9)
    frac = t_compute / max(terms[dominant], 1e-12)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "multi_pod": rec["multi_pod"],
        "status": "ok",
        "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": frac,
        "model_flops_per_device": mf,
        "useful_flops_ratio": useful,
        "mem_per_device_gib": rec["memory"]["peak_estimate_bytes"] / 2**30,
        "fits_hbm_80g": rec["memory"]["peak_estimate_bytes"] < HBM_BYTES,
    }


def bottleneck_note(row: dict) -> str:
    d = row["dominant"]
    if d == "memory":
        return "fuse/rematerialize: cut op-boundary traffic (attention mask + recurrence carries)"
    if d == "collective":
        return "reshard or overlap: reduce per-layer TP reductions / FSDP gathers"
    return "compute-bound: raise MFU via larger per-device tiles"


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s (upper bound) | collective s | "
           "dominant | roofline frac | useful FLOP ratio | mem GiB (estimate) | fits 80G |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        mesh = "2pod" if r["multi_pod"] else "1pod"
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | — | — | — | {r['status']} | "
                       f"— | — | — | {r.get('reason', '')[:60]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | "
            f"{r['t_compute_s']:.3g} | {r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | "
            f"{r['dominant']} | {r['roofline_fraction']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | {r['mem_per_device_gib']:.2f} | "
            f"{'yes' if r['fits_hbm_80g'] else 'NO'} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all-meshes", action="store_true")
    args = ap.parse_args(argv)

    mp = None if args.all_meshes else args.multi_pod
    rows = [analyze(r) for r in load_cells(mp)]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["multi_pod"]))
    if args.markdown:
        print(markdown_table(rows))
    else:
        for r in rows:
            if r["status"] != "ok":
                print(f"{r['arch']:24s} {r['shape']:12s} {r['status']}: {r.get('reason', '')[:60]}")
                continue
            print(
                f"{r['arch']:24s} {r['shape']:12s} {'2pod' if r['multi_pod'] else '1pod'} "
                f"C={r['t_compute_s']:.3g}s M={r['t_memory_s']:.3g}s X={r['t_collective_s']:.3g}s "
                f"dom={r['dominant']:10s} frac={r['roofline_fraction']:.2f} "
                f"useful={r['useful_flops_ratio']:.2f} mem={r['mem_per_device_gib']:.1f}GiB"
            )
    path = os.path.join(os.path.dirname(OUT_DIR), "roofline.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\n-> {path}", flush=True)


if __name__ == "__main__":
    main()
