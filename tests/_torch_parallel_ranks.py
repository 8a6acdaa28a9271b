"""Rank bodies of tests/test_torch_parallel.py. Spawned ranks import this
module by name, so it imports the PyTorch port only (never JAX, never the
JAX package); the test holds what the ranks return against the JAX
package, computed in the pytest process."""

import dataclasses
import sys

import torch

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.parallel.dryrun import dryrun_multichip
from bmsparse_tpu_torch.parallel.partition import partition
from bmsparse_tpu_torch.parallel.plan import prepare_sharded
from bmsparse_tpu_torch.parallel.product import (
    prepare_sharded_product, sharded_multiply,
)
from bmsparse_tpu_torch.parallel.spgemm import estimate_bounds, sharded_spgemm
from bmsparse_tpu_torch.parallel.spmv import (
    sharded_spmv, sharded_spmv_prepared,
)


def _m(case, transposed=False):
    r, c, v, shape = case
    return bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                              device="cpu")


def workload(mesh, cases: dict) -> dict:
    """Every multi-device entry point on the launched gloo mesh; host
    results keyed by name."""
    d = mesh.size
    out = {}
    m = _m(cases["spmv"])
    out["spmv"] = sharded_spmv(partition(m, d), torch.from_numpy(
        cases["v_spmv"]), mesh).numpy()
    for name in ("band", "skewed", "tall"):
        sp = prepare_sharded(partition(_m(cases[name]), d, align=16))
        v = torch.from_numpy(cases["v_" + name])
        for ex in ("halo", "allgather"):
            if ex == "halo" and sp.halo is None:
                continue
            out[f"{name}_{ex}"] = sharded_spmv_prepared(
                sp, v, mesh, exchange=ex).numpy()
    sa = partition(_m(cases["ga"]), d)
    sb = partition(_m(cases["gb"], transposed=True), d)
    c = sharded_spgemm(sa, sb, mesh, **estimate_bounds(sa, sb))
    out["spgemm"] = c.to_bmsparse().generate_coo()
    out["spgemm_nb"] = c.nb.numpy()
    for name in ("prod_band", "prod_random"):
        a = _m(cases[name])
        sa = partition(a, d, align=16)
        sb = partition(_m(cases[name], transposed=True), d, align=16)
        spp = prepare_sharded_product(sa, sb)
        out[name] = sharded_multiply(spp, mesh).to_bmsparse().generate_coo()
        # structure-frozen: new values with the same structure
        spp2 = dataclasses.replace(spp, a_flat=spp.a_flat * 2.0)
        out[name + "_x2"] = sharded_multiply(
            spp2, mesh).to_bmsparse().generate_coo()
        out[name + "_exchange"] = spp.exchange
    out["dryrun"] = dryrun_multichip(d, "cpu")
    out["imported_jax"] = sorted(
        k for k in sys.modules
        if k == "jax" or k.startswith("jax.") or k == "bmsparse_tpu"
        or k.startswith("bmsparse_tpu."))
    out["rank"] = mesh.rank
    return out
