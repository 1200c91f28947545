"""Roofline analysis of the dry-run records: reads the JSON files
``launch.dryrun_graph`` (per superstep) and ``launch.dryrun`` (per LM
step) write and derives three terms per cell on the constants of an
NVIDIA H100 80GB HBM3 at its 700.00 W power limit (as ``nvidia-smi``
reports the card the port is measured on):

  compute term    = dot_FLOPs / 989e12 + semiring ops / 67e12      [s]
  memory term     = bytes every op reads and writes / 3.35e12      [s]
  collective term = ring wire bytes / link rate                    [s]

The link rate is NVLink's 450 GB/s a direction when the mesh fits in one
8-card node, else a card's 50 GB/s network port (400 Gb/s NDR), which a
collective over more than 8 cards crosses. The counts come from running
the program on fake tensors (``launch/fake_stats.py``). ``fits_hbm`` holds
one rank's arguments plus temporaries against the card's memory
(``hbm_capacity``). An LM row also carries ``model_flops`` (6·N·D for
training, 2·N·D otherwise; N the MoE-aware active parameters, as the JAX
package counts them), ``useful_ratio`` (model FLOPs over the dot FLOPs
the ranks run) and ``roofline_fraction``.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--dry results/dryrun] [--out results/roofline.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

# NVIDIA H100 80GB HBM3, 700.00 W power limit: the data sheet's rates
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12          # dense bf16 dot FLOP/s (tensor cores)
PEAK_FP32 = 67e12            # fp32 FLOP/s outside the tensor cores: the
                             # semiring ops, which have no tensor-core path
HBM_BW = 3.35e12             # HBM3 B/s
NVLINK_BW = 450e9            # NVLink B/s a direction, cards of one node
NET_BW = 50e9                # B/s a card across nodes (400 Gb/s NDR)
NODE_CARDS = 8               # cards one NVLink domain joins
HBM_CAP_DEFAULT = 80 * 10**9  # the card's 80 GB where no card is present

_PARAM_CACHE = {}


def hbm_capacity() -> int:
    """The card's memory in bytes as ``torch.cuda.get_device_properties(0)
    .total_memory`` reads it, or ``HBM_CAP_DEFAULT`` with no card."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HBM_CAP_DEFAULT


def link_bw(n_devices: int) -> float:
    """The rate a collective over ``n_devices`` cards runs at per card."""
    return NVLINK_BW if n_devices <= NODE_CARDS else NET_BW


def param_counts(arch: str):
    """(n_total, n_active) parameters (active = per-token, MoE-aware): the
    model built on the ``meta`` device, a routed expert weight of a block
    counted at top_k / n_experts."""
    if arch in _PARAM_CACHE:
        return _PARAM_CACHE[arch]
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    total = active = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        if cfg.moe and ("w_gate" in name or "w_up" in name or
                        "w_down" in name) and "blocks" in name:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    _PARAM_CACHE[arch] = (int(total), int(active))
    return _PARAM_CACHE[arch]


def model_flops(rec: dict) -> float:
    """Spec MODEL_FLOPS for the cell (total across cards)."""
    from repro_torch.models.config import SHAPES
    sh = SHAPES[rec["shape"]]
    n_total, n_active = param_counts(rec["arch"])
    if sh["kind"] == "train":
        tokens = sh["seq_len"] * sh["global_batch"]
        return 6.0 * n_active * tokens
    if sh["kind"] == "prefill":
        tokens = sh["seq_len"] * sh["global_batch"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * sh["global_batch"]


def analyze_record(rec: dict, hbm_cap: int = None) -> dict:
    """The record with its roofline terms (per superstep for a graph cell)
    and ``fits_hbm``: one rank's arguments plus temporaries against
    ``hbm_cap`` (``hbm_capacity()`` when not given)."""
    if rec.get("status") != "ok":
        return dict(rec, terms=None)
    cap = hbm_capacity() if hbm_cap is None else hbm_cap
    w = rec["walk"]
    n_dev = rec["n_devices"]
    t_comp = w["dot_flops_per_device"] / PEAK_FLOPS \
        + w.get("semiring_ops_per_device", 0) / PEAK_FP32
    t_mem = w["hbm_bytes_per_device"] / HBM_BW
    t_coll = w["collective_wire_bytes_per_device"] / link_bw(n_dev)
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mem = rec.get("memory", {})
    footprint = mem.get("temp_size_in_bytes", 0) + \
        mem.get("argument_size_in_bytes", 0)
    mf = model_flops(rec) if rec.get("kind") != "graph_engine" else None
    dot_total = w["dot_flops_per_device"] * n_dev
    out = dict(rec)
    out.update(
        terms=terms, dominant=dominant.replace("_s", ""),
        bound_s=max(terms.values()),
        model_flops=mf,
        useful_ratio=(mf / dot_total) if (mf and dot_total) else None,
        roofline_fraction=(min(mf / n_dev / PEAK_FLOPS, t_comp)
                           / max(max(terms.values()), 1e-30)) if mf else None,
        fits_hbm=footprint <= cap, hbm_cap=cap,
        temp_gib=mem.get("temp_size_in_bytes", 0) / 2 ** 30,
        args_gib=mem.get("argument_size_in_bytes", 0) / 2 ** 30,
    )
    return out


def suggestion(row: dict) -> str:
    if row.get("terms") is None:
        return ""
    d = row["dominant"]
    coll = row["walk"].get("collective_by_kind", {})
    top_coll = max(coll, key=coll.get) if coll else ""
    graph = row.get("kind") == "graph_engine"
    if d == "collective":
        return (f"dominated by {top_coll}; reduce via sharding that keeps "
                "the operand local, comm-compute overlap, or smaller "
                "payloads " + ("(the per-sweep edge-group combine first)"
                               if graph else
                               "(activation partial sums in bf16, fewer "
                               "gathers of replicated weights)"))
    if d == "memory":
        return ("HBM-bound: fuse the sweep's gather/scatter passes, or "
                "shard the live tensors further" if graph else
                "HBM-bound: fuse the elementwise passes around the "
                "matmuls, or shard the replicated mixers over model")
    if (row.get("useful_ratio") or 1) < 0.4:
        return "compute-bound but low useful ratio: cut remat recompute"
    return "compute-bound: near the right regime; raise per-card utilization"


def _name(r: dict) -> str:
    name = r.get("arch") or f"graph:{r.get('scale')}"
    if r.get("variant") not in (None, "base", "opt"):
        name += f" [{r['variant']}]"
    return name


def markdown_table(rows) -> str:
    lines = ["| arch | shape | mesh | compute s | memory s | collective s | "
             "dominant | MODEL/dot | roofline frac | args GiB | temp GiB | "
             "fits |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r.get("arch", r.get("scale", "")),
                                         r.get("shape", r.get("algo", "")),
                                         r["mesh"])):
        if r.get("status") == "skipped":
            shape = r.get("shape") or r.get("algo")
            lines.append(f"| {_name(r)} | {shape} | {r['mesh']} | — | — | "
                         f"— | skipped | — | — | — | — | "
                         f"{r['reason'][:70]}… |")
            continue
        if r.get("terms") is None:
            continue
        t = r["terms"]
        ur = f"{r['useful_ratio']:.2f}" if r.get("useful_ratio") else "—"
        rf = f"{r['roofline_fraction']:.2f}" if r.get("roofline_fraction") \
            else "—"
        shape = r.get("shape") or r.get("algo")
        lines.append(
            f"| {_name(r)} | {shape} | {r['mesh']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{r['dominant']} | {ur} | {rf} | {r['args_gib']:.3f} | "
            f"{r['temp_gib']:.3f} | {'y' if r['fits_hbm'] else 'NO'} |")
    return "\n".join(lines)


def load_all(dry_dir: str, hbm_cap: int = None):
    rows = []
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            rows.append(analyze_record(json.load(f), hbm_cap))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", default="results/dryrun")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args(argv)
    cap = hbm_capacity()
    rows = load_all(args.dry, cap)
    md = [f"# Roofline per superstep (graph) / per step (LM) ({CARD}: "
          f"989 TFLOP/s bf16 dot, "
          f"67 TFLOP/s fp32, 3.35 TB/s HBM, 450 GB/s NVLink within "
          f"{NODE_CARDS} cards, 50 GB/s across nodes; fits against "
          f"{cap} B)", "", markdown_table(rows), "", "## Bottleneck notes",
          ""]
    for r in rows:
        if r.get("terms") is None:
            continue
        md.append(f"- **{_name(r)} / {r.get('shape') or r.get('algo')} / "
                  f"{r['mesh']}** — {r['dominant']}-bound "
                  f"({r['bound_s']:.2e}s): {suggestion(r)}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(md) + "\n")
    with open(args.out.replace(".md", ".json"), "w") as f:
        json.dump([{k: v for k, v in r.items()
                    if k not in ("traceback",)} for r in rows], f, indent=1,
                  default=str)
    ok = sum(1 for r in rows if r.get("status") == "ok")
    print(f"wrote {args.out}: {ok} analyzed cells")


if __name__ == "__main__":
    main()
