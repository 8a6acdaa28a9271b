"""Multi-device scaling report — counterpart of
``bmsparse_tpu/cli/scaling.py``, for NVIDIA cards.

Two kinds of evidence, kept apart:

  * PLAN-TIME and MEASURED: each exchange's payload is a plan-time
    quantity (the all-gather of v moves (d-1)/d of the vector to every
    GPU, a halo exchange the two neighbour windows the plan proved, the
    sharded product's exchange exactly the needed B tiles), and so is
    each shard's share of the blocks (`shard_imbalance`). Where the run
    has ranks — d up to the number of cards with --device cuda (NCCL),
    up to --cpu-ranks with --device cpu (gloo) — a row also holds a
    `measured` entry: the sharded SpMV and product on those ranks,
    checked against scipy in float64, with their time (CUDA events on
    the card, the slowest rank's; on the CPU a host-clock time, labelled
    UNREPRESENTATIVE, which says only that the path runs).
  * PROJECTED: a bandwidth model with figures from NVIDIA's data sheets,
    not measurements. A GPU's compute time is the HBM roofline of its
    d-th of the work (utils/roofline.py); its communication time is the
    exchange's bytes over the link. Projected efficiency = t_compute /
    (t_compute + t_comm) (serialized) and / max(...) (overlapped) bound
    the real machine from both sides. The port issues each exchange
    synchronously before its local products, so its code reaches the
    serialized figure (the JAX package's probe of the compiled schedule,
    `probe_overlap_hlo`, has no counterpart here).

The model. GPUs are numbered node-major in DGX/HGX H100 nodes of 8: GPU r
sits in node r // 8 on rail r % 8. Inside a node every GPU reaches every
other through NVSwitch at the card's link rate each way (H100 SXM5:
NVLink 4, 900 GB/s in total, 450 GB/s each way; an H100 PCIe card has
PCIe Gen5 x16, 64 GB/s each way); the `projected` columns treat all d
GPUs as one such domain. Between nodes each GPU has its own 400 Gb/s
ConnectX-7 port, 50 GB/s each way, on a rail-optimised fabric, so its
off-node traffic leaves through its own port; for d > 8,
`projected_multinode` charges the slowest GPU: under a halo exchange the
GPU at a node boundary receives one side's halo (the larger) through its
port; an all-gather of v runs along the rail first (nodes - 1 slices of
v/d through the port) and then inside the node (7 * nodes slices over
the link), one stage after the other; the product's all_to_all sends
d - 8 of a GPU's d - 1 pair shares through its port while the other 7
ride the link at the same time (the slower of the two counts).

Usage:
  python -m bmsparse_tpu_torch.cli.scaling --synthetic band --n 262144 \\
      [--devices 1,2,4,8] [--report SCALING.json] [--device {cuda,cpu}] \\
      [--cpu-ranks N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..utils import roofline as rl

# Interconnect figures from NVIDIA's data sheets, GB/s each way, looked up
# by a substring of torch.cuda.get_device_name(); the first match wins.
#   H100 PCIe: PCIe Gen5 x16, 64 GB/s each way.
#   H100 SXM5 (get_device_name: "NVIDIA H100 80GB HBM3"): NVLink 4, 900
#   GB/s in total, 450 GB/s each way, to every GPU of its node through
#   NVSwitch.
_LINKS = (
    ("H100 PCIe", "H100 PCIe", "PCIe Gen5 x16", 64.0),
    ("H100 SXM", "H100 SXM5", "NVLink 4 through NVSwitch", 450.0),
    ("H100 80GB HBM3", "H100 SXM5", "NVLink 4 through NVSwitch", 450.0),
)
# the row the model takes where no card, or a card not in the table, runs
_DEFAULT_LINK = _LINKS[1][1:]
# DGX/HGX H100: 8 GPUs per node, each with one 400 Gb/s ConnectX-7 port
# (50 GB/s each way) on a rail-optimised fabric
GPUS_PER_NODE = 8
NETWORK_GBPS_PER_GPU = 50.0
# measured entries are ok below this max|err| / max|ref| against scipy
MEASURED_REL = 1e-3


def link_model(card: str | None) -> dict:
    """The model's figures for the card called `card` (None: no card)."""
    for key, *row in _LINKS:
        if card is not None and key in card:
            figures, link, gbps = row
            note = f"{card}: the {figures} row"
            break
    else:
        figures, link, gbps = _DEFAULT_LINK
        note = (f"no CUDA device: the {figures} row" if card is None
                else f"{card} is not in the table: the {figures} row")
    return {
        "card": card,
        "figures": figures,
        "link": link,
        "link_gbps": gbps,
        "hbm_gbps": rl.device_hbm_gbps(figures),
        "gpus_per_node": GPUS_PER_NODE,
        "network_gbps_per_gpu": NETWORK_GBPS_PER_GPU,
        "note": (note + "; NVIDIA data-sheet figures, not measurements. "
                 "projected = HBM-roofline compute vs link bandwidth; "
                 "bytes are exact plan-time payloads; measured rows ran "
                 "on the ranks named in them; the exchange is issued "
                 "synchronously (no overlap probe)"),
    }


def _allgather_seconds(total_bytes: int, d: int, gbps: float) -> float:
    """All-gather: every GPU receives (d-1)/d of the payload."""
    if d <= 1:
        return 0.0
    return total_bytes * (d - 1) / d / (gbps * 1e9)


def _estimate_spgemm_tasks(m) -> int:
    """Cheap host-side task-volume estimate for C = A @ A (B = A^T
    layout): every A block (i, k) pairs with every block of A's block
    column k. Refuses SpGEMM planning that cannot finish (a 256k-row
    webgraph's hubs produce 131M tasks)."""
    bcol = m.bcol[: int(m.nb)].cpu().numpy()
    per_col = np.bincount(bcol, minlength=max(int(bcol.max(initial=0)) + 1, 1))
    return int(per_col[bcol].sum())


def _efficiency(t_comp: float, t_comm: float) -> dict:
    return {"efficiency_serialized": t_comp / (t_comp + t_comm),
            "efficiency_overlapped": t_comp / max(t_comp, t_comm)}


def _nodes(d: int) -> int:
    return -(-d // GPUS_PER_NODE)


# ---------------------------------------------------------------------------
# measured rows: run in every rank of a process group
# ---------------------------------------------------------------------------
def _arrays(m) -> dict:
    """A float32 BmSparse as the keyword arguments of
    interop.bmsparse_from_numpy (what run_ranks pickles into each rank)."""
    from ..format.bitmap import tensor_to_words_np

    h = m.to("cpu")
    arrays = {f: getattr(h, f).numpy()
              for f in ("brow", "bcol", "offsets", "values")}
    arrays.update(bmp_hi=tensor_to_words_np(h.bmp_hi),
                  bmp_lo=tensor_to_words_np(h.bmp_lo), nb=int(h.nb))
    return {"arrays": arrays, "num_rows": h.num_rows,
            "num_cols": h.num_cols, "nnz": h.nnz,
            "transposed": h.transposed}


def _slowest(mesh, t: float) -> float:
    """The largest of the ranks' times."""
    import torch.distributed as dist

    x = torch.tensor([t], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(x[0])


def _measure(mesh, a_arrays: dict, b_arrays: dict | None, v: np.ndarray,
             iters: int) -> dict:
    """The sharded SpMV (and product, given B) of one row on `mesh`,
    against scipy in float64; times are the slowest rank's."""
    import torch.distributed as dist

    from ..interop import bmsparse_from_numpy
    from ..parallel.partition import partition
    from ..parallel.plan import prepare_sharded
    from ..parallel.product import prepare_sharded_product, sharded_multiply
    from ..parallel.spmv import _resolve_exchange, sharded_spmv_prepared
    from ..utils.timing import time_op

    dev, d = mesh.device, mesh.size
    on_card = dev.type == "cuda"
    where = {"world": d, "backend": dist.get_backend(mesh.group),
             "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    time_key = "seconds" if on_card else "cpu_seconds_UNREPRESENTATIVE"

    a = bmsparse_from_numpy(**a_arrays, device=dev)
    sa = partition(a, d, align=16)
    sp = prepare_sharded(sa)
    vt = torch.from_numpy(v).to(dev)
    t, u = time_op(lambda: sharded_spmv_prepared(sp, vt, mesh), iters=iters,
                   device=dev)
    a_sp = a.to_scipy().tocsr()
    ref = a_sp @ v.astype(np.float64)
    err = float(np.max(np.abs(u.cpu().double().numpy() - ref))
                / max(float(np.max(np.abs(ref))), 1e-30))
    out = {"spmv": {"ok": bool(err < MEASURED_REL), "max_rel_err": err,
                    "exchange": _resolve_exchange(sp, "auto"),
                    time_key: _slowest(mesh, t), **where}}
    if b_arrays is None:
        return out

    spp = prepare_sharded_product(
        sa, partition(bmsparse_from_numpy(**b_arrays, device=dev), d,
                      align=16))
    t, c = time_op(lambda: sharded_multiply(spp, mesh), iters=iters,
                   device=dev)
    refm = (a_sp @ a_sp).tocsr()
    diff = abs(c.to_bmsparse().to_scipy().tocsr() - refm)
    dmax = diff.max() if diff.nnz else 0.0
    err = float(dmax / max(abs(refm).max(), 1e-30))
    out["spgemm"] = {"ok": bool(err < MEASURED_REL), "max_rel_err": err,
                     "exchange": spp.exchange, time_key: _slowest(mesh, t),
                     **where}
    return out


def measure_rank(mesh, sizes, a_arrays: dict, b_arrays: dict | None,
                 v: np.ndarray, iters: int) -> dict:
    """run_ranks entry, called in every rank of `mesh`: for each d in
    sizes (none above mesh.size) the first d ranks measure the row on a
    group of their own (the mesh itself at d = mesh.size). Returns
    {d: _measure(...)} for the rows this rank took part in."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    out = {}
    for d in sizes:
        whole = d == mesh.size
        # every rank of the mesh takes part in creating a subgroup
        group = mesh.group if whole else dist.new_group(list(range(d)))
        if mesh.rank < d:
            out[d] = _measure(make_mesh(d, mesh.device, group=group),
                              a_arrays, b_arrays, v, iters)
            if not whole:
                dist.destroy_process_group(group)
    return out


def _ranks(device: torch.device, cpu_ranks: int) -> tuple:
    """(the ranks a run on `device` has, the mesh of an initialised
    process group whose backend serves `device` or None): that group's
    size, else the cards present ("cuda") or cpu_ranks ("cpu")."""
    import torch.distributed as dist

    from ..parallel.mesh import BACKENDS, make_mesh

    if (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == BACKENDS[device.type]):
        world = dist.get_world_size()
        return world, make_mesh(world, device.type)
    if device.type == "cuda":
        return torch.cuda.device_count(), None
    return cpu_ranks, None


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def build_report(m, sizes, v, iters: int = 5, device="cuda",
                 cpu_ranks: int = 0,
                 spgemm_task_budget: int = 20_000_000) -> dict:
    """The scaling report of a float32 matrix m for the mesh sizes in
    `sizes`, with v (numpy or a tensor) as the SpMV operand.

    Plans and projections are built on the host for every d. Measured
    entries: on `device` "cuda" for d up to the cards present, on "cpu"
    for d up to `cpu_ranks` (gloo). An initialised process group whose
    backend serves `device` is used as it is (every rank of it must call
    build_report); otherwise run_ranks spawns the ranks."""
    from ..format.convert import coo_to_bmsparse
    from ..parallel.launch import run_ranks
    from ..parallel.partition import partition
    from ..parallel.plan import prepare_sharded
    from ..parallel.product import prepare_sharded_product
    # by its module's name: spawned ranks cannot import __main__'s copy
    from .scaling import measure_rank as rank_fn

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_report: no CUDA device; pass device='cpu'")
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)
    model = link_model(card)
    link = model["link_gbps"] * 1e9
    net = NETWORK_GBPS_PER_GPU * 1e9
    mh = m.to("cpu")
    v = (v.cpu().numpy() if isinstance(v, torch.Tensor)
         else np.asarray(v)).astype(np.float32)

    nnz = mh.nnz
    v_bytes = mh.num_cols * 4
    report = {
        "matrix": {"shape": list(mh.shape), "nnz": nnz, "blocks": int(mh.nb)},
        "model": model,
        "spmv": [],
        "spgemm": [],
    }
    # single-GPU compute floor: the single-device roofline's bytes
    t_compute_1 = rl.spmv_min_bytes(
        nnz, int(mh.nb), mh.num_rows, mh.num_cols
    ) / (model["hbm_gbps"] * 1e9)

    rows = {}
    for d in sizes:
        t_comp = t_compute_1 / d
        sm = partition(mh, d, align=16)
        # one shard exchanges nothing: its plan is not needed for the row
        halo = prepare_sharded(sm).halo if d > 1 else None
        nbs = sm.nb.numpy()
        # a halo exchange moves the two plan-proven windows; general
        # sparsity all-gathers v
        if halo is not None and d > 1:
            nv_bytes = (halo[0] + halo[1]) * 4
            t_comm = nv_bytes / link
        else:
            nv_bytes = int(v_bytes * (d - 1) / d)
            t_comm = _allgather_seconds(v_bytes, d, model["link_gbps"])
        row = {"d": d,
               "shard_imbalance": float(nbs.max() / max(nbs.mean(), 1e-9)),
               "projected": {
                   "compute_s": t_comp,
                   "nvlink_s": t_comm,
                   "nvlink_bytes_per_gpu": nv_bytes,
                   "exchange": "halo" if (halo and d > 1) else "allgather",
                   **_efficiency(t_comp, t_comm)}}
        if d > GPUS_PER_NODE:
            nodes = _nodes(d)
            if halo is not None:
                net_bytes = max(halo[0], halo[1]) * 4
                t_comm_n = net_bytes / net
            else:
                slice_bytes = v_bytes / d
                net_bytes = int(slice_bytes * (nodes - 1))
                t_comm_n = (slice_bytes * (nodes - 1) / net + slice_bytes
                            * (GPUS_PER_NODE - 1) * nodes / link)
            row["projected_multinode"] = {
                "nodes": nodes, "gpus_per_node": GPUS_PER_NODE,
                "network_gbps_per_gpu": NETWORK_GBPS_PER_GPU,
                "network_bytes_per_gpu": net_bytes,
                "worst_gpu_comm_s": t_comm_n,
                **_efficiency(t_comp, t_comm_n)}
        report["spmv"].append(row)
        rows[d] = row

    # SpGEMM (A . A, B in transposed layout): selective-exchange payloads
    bt = None
    est_tasks = _estimate_spgemm_tasks(mh)
    if est_tasks > spgemm_task_budget:
        report["spgemm_skipped"] = {
            "estimated_tasks": est_tasks,
            "task_budget": spgemm_task_budget,
            "note": "A@A task volume exceeds the host planning budget; "
                    "rerun with a smaller --n or raise "
                    "--spgemm-task-budget",
        }
    else:
        sco = mh.to_scipy().tocoo()
        bt = coo_to_bmsparse(
            sco.row.astype(np.int32), sco.col.astype(np.int32),
            sco.data.astype(np.float32), mh.shape, transposed=True,
            backend="host", device="cpu")
        for d in sizes:
            if d < 2:
                continue
            spp = prepare_sharded_product(partition(mh, d, align=16),
                                          partition(bt, d, align=16))
            # the selective wire bytes pad every off-diagonal pair to
            # max_send; useful counts real tiles only
            sel = spp.comm_bytes_selective
            allg = spp.comm_bytes_allgather
            wire = sel if spp.exchange == "selective" else allg
            t_comm = wire / d / link
            # numeric compute floor: two operand tiles per slot, per GPU
            # (spp.tas shapes are per shard: (d, cap, K, 128))
            slots_per_shard = sum(
                int(np.prod(np.asarray(t.shape[1:]))) for t in spp.tas)
            t_comp = slots_per_shard * 2 * 256 / (model["hbm_gbps"] * 1e9)
            row = {
                "d": d,
                "exchange": spp.exchange,
                "max_send": int(spp.max_send),
                "selective_wire_bytes_total": int(sel),
                "selective_useful_bytes_total": int(spp.comm_bytes_useful),
                "allgather_bytes_total": int(allg),
                "selective_fraction": sel / max(allg, 1),
                "padding_overhead": sel / max(spp.comm_bytes_useful, 1),
                "plan_seconds_host": float(spp.plan_seconds),
                "projected": {"compute_s": t_comp, "nvlink_s": t_comm,
                              **_efficiency(t_comp, t_comm)},
            }
            if d > GPUS_PER_NODE:
                per_pair = wire / max(d * (d - 1), 1)
                net_bytes = per_pair * (d - GPUS_PER_NODE)
                t_comm_n = max(net_bytes / net,
                               per_pair * (GPUS_PER_NODE - 1) / link)
                row["projected_multinode"] = {
                    "nodes": _nodes(d), "gpus_per_node": GPUS_PER_NODE,
                    "network_gbps_per_gpu": NETWORK_GBPS_PER_GPU,
                    "network_bytes_per_gpu": int(net_bytes),
                    "worst_gpu_comm_s": t_comm_n,
                    **_efficiency(t_comp, t_comm_n)}
            report["spgemm"].append(row)

    # measured entries, where the run has ranks
    avail, mesh = _ranks(device, cpu_ranks)
    measured = sorted({d for d in sizes if d <= avail})
    if measured:
        args = (measured, _arrays(mh), _arrays(bt) if bt is not None
                else None, v, iters)
        got = (measure_rank(mesh, *args) if mesh is not None
               else run_ranks(rank_fn, max(measured), device.type,
                              *args)[0])
        for d, res in got.items():
            rows[d]["measured"] = res["spmv"]
            if "spgemm" not in res:
                continue
            prow = next((r for r in report["spgemm"] if r["d"] == d), None)
            if prow is None:
                # d = 1 has no exchange to project: the measured
                # single-device product is the row's only entry
                prow = {"d": d}
                report["spgemm"].insert(0, prow)
            prow["measured"] = res["spgemm"]
    return report


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def synthetic(kind: str, n: int):
    """The report's synthetic matrices as COO (rows, cols, vals, shape),
    made as the JAX package's CLI makes them: "band" (16 offsets drawn in
    [-8, 8]), "stencil" (all 17 offsets) or "web" (power-law hubs, the
    skew case the selective exchange must survive)."""
    from ..utils.testmats import webgraph

    if kind == "web":
        return webgraph(n, avg_deg=8, seed=9)
    rng = np.random.default_rng(0)
    if kind == "stencil":
        offs = np.arange(-8, 9)
    else:
        offs = rng.integers(-8, 9, size=16)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = np.clip(rows + np.tile(offs, n), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bmsparse-scaling-torch")
    p.add_argument("folder", nargs="?", help="matrix directory")
    p.add_argument("a_name", nargs="?", help="matrix name (without .mtx)")
    p.add_argument("--synthetic", choices=["band", "stencil", "web"],
                   default=None)
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--devices", default=None,
                   help="comma-separated mesh sizes (default: 1, 2, 4, 8 "
                        "and the powers of two up to the ranks available)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--spgemm-task-budget", type=int, default=20_000_000,
                   help="skip the SpGEMM section (with a recorded reason) "
                        "when the A@A task estimate exceeds this")
    p.add_argument("--report", default=None, help="write JSON report here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where measured rows run (default cuda: NCCL over "
                        "the cards present)")
    p.add_argument("--cpu-ranks", type=int, default=0,
                   help="with --device cpu: gloo ranks for measured rows "
                        "(d up to this many; default 0, none)")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available "
                "(use --device cpu)")

    from .. import coo_to_bmsparse, mmread_bmsparse

    if args.synthetic:
        rows, cols, vals, shape = synthetic(args.synthetic, args.n)
        m = coo_to_bmsparse(rows, cols, vals, shape, backend="host",
                            device="cpu")
    elif args.folder and args.a_name:
        import os

        m = mmread_bmsparse(os.path.join(args.folder, args.a_name),
                            device="cpu")
    else:
        p.error("need folder+name or --synthetic")

    total, _ = _ranks(torch.device(args.device), args.cpu_ranks)
    sizes = ([int(x) for x in args.devices.split(",")] if args.devices
             else [d for d in (1, 2, 4, 8, 16, 32) if d <= max(8, total)])
    rng = np.random.default_rng(1)
    v = rng.standard_normal(m.num_cols).astype(np.float32)

    print(f"matrix {m.shape}, nnz {m.nnz}; ranks available on "
          f"{args.device}: {total}")
    report = build_report(m, sizes, v, iters=args.iters, device=args.device,
                          cpu_ranks=args.cpu_ranks,
                          spgemm_task_budget=args.spgemm_task_budget)
    print(f"  model: {report['model']['note']}")
    if "spgemm_skipped" in report:
        sk = report["spgemm_skipped"]
        print(f"  spgemm: skipped ({sk['estimated_tasks']} estimated "
              f"tasks > budget {sk['task_budget']})")
    for row in report["spmv"]:
        pr = row["projected"]
        print(f"  spmv d={row['d']:3d}: projected eff "
              f"{pr['efficiency_serialized']*100:5.1f}% (serialized) / "
              f"{pr['efficiency_overlapped']*100:5.1f}% (overlapped); "
              f"NVLink {pr['nvlink_bytes_per_gpu']} B/GPU; imbalance "
              f"{row['shard_imbalance']:.2f}" + _measured_text(row))
        mn = row.get("projected_multinode")
        if mn:
            print(f"       multinode ({mn['nodes']} nodes x "
                  f"{mn['gpus_per_node']} GPUs, rail model): eff "
                  f"{mn['efficiency_serialized']*100:5.1f}%/"
                  f"{mn['efficiency_overlapped']*100:5.1f}%")
    for row in report["spgemm"]:
        if "selective_fraction" in row:
            pr = row["projected"]
            print(f"  spgemm d={row['d']:3d}: selective exchange "
                  f"{row['selective_fraction']*100:.1f}% of all-gather "
                  f"bytes; projected eff "
                  f"{pr['efficiency_serialized']*100:.1f}%/"
                  f"{pr['efficiency_overlapped']*100:.1f}%"
                  + _measured_text(row))
        else:
            print(f"  spgemm d={row['d']:3d}: no exchange"
                  + _measured_text(row))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.report}")
    return 0


def _measured_text(row) -> str:
    ms = row.get("measured")
    if not ms:
        return ""
    if "seconds" in ms:
        t = f"{ms['seconds'] * 1e3:.4f} ms (CUDA events)"
    else:
        t = (f"{ms['cpu_seconds_UNREPRESENTATIVE'] * 1e3:.2f} ms (CPU, "
             f"unrepresentative)")
    return (f"; measured on {ms['world']} {ms['backend']} ranks ok="
            f"{ms['ok']} err {ms['max_rel_err']:.1e} {t}")


if __name__ == "__main__":
    sys.exit(main())
