"""The multi-device dry run — counterpart of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py``: one block-row-sharded SpGEMM + SpMV step
and the fast paths, checked against scipy, on an n-rank mesh.

Call it in every rank of an initialised process group (parallel/launch.py):

    run_ranks(dryrun_rank, 4, "cpu")        # four gloo ranks on the CPU

It checks C of the structure-oblivious SpGEMM through the SpMV (u = C @
v), the tiered SpMV, the sharded product's C, the selective exchange's
bytes against the all-gather's, and a 262,144-row banded SpMV through the
plan-proven halo exchange (relative error < 1e-3).
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_matrices(shape=(256, 256), density=0.03, seed=0, device="cuda"):
    """A, transposed B = A and v, as the JAX package's dry run makes them."""
    from ..format.convert import coo_to_bmsparse

    rng = np.random.default_rng(seed)
    m, n = shape
    nnz = max(1, int(m * n * density))
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = np.divmod(flat, n)
    vals = rng.standard_normal(nnz).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = (rows[order].astype(np.int32),
                        cols[order].astype(np.int32), vals[order])
    a = coo_to_bmsparse(rows, cols, vals, shape, device=device)
    bt = coo_to_bmsparse(rows, cols, vals, shape, transposed=True,
                         device=device)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    return a, bt, v


def big_band(device, nbig: int = 262144):
    """The dry run's 262,144-row band: 4 draws per row at offsets in
    [-2, 2], and v."""
    from ..format.convert import coo_to_bmsparse

    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(nbig, dtype=np.int64), 4)
    offs = rng.integers(-2, 3, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, nbig - 1)
    key = np.unique(rows * nbig + cols)
    rows, cols = np.divmod(key, nbig)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    big = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                          vals, (nbig, nbig), device=device)
    vbig = torch.from_numpy(
        rng.standard_normal(nbig).astype(np.float32)).to(device)
    return big, vbig


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded SpGEMM + SpMV step and the fast paths on this rank's
    n_devices mesh, checked against scipy (raises on a failed check).
    Returns the results as host arrays: u (= A @ A @ v through
    sharded_spgemm and sharded_spmv), u2 (the tiered SpMV), c (the sharded
    product's C as (rows, cols, values)), u3 (the 262,144-row halo SpMV),
    the errors and the exchange bytes."""
    from .mesh import make_mesh
    from .partition import partition
    from .plan import prepare_sharded
    from .product import prepare_sharded_product, sharded_multiply
    from .spgemm import estimate_bounds, sharded_spgemm
    from .spmv import sharded_spmv, sharded_spmv_prepared

    mesh = make_mesh(n_devices, device)
    dev = mesh.device
    a, bt, v = _sample_matrices(shape=(128, 128), density=0.05, seed=1,
                                device=dev)
    sa = partition(a, n_devices)
    sb = partition(bt, n_devices)

    # full step: C = A @ B (B all-gathered), u = C @ v (v all-gathered)
    c = sharded_spgemm(sa, sb, mesh, **estimate_bounds(sa, sb))
    u = sharded_spmv(c, v, mesh)

    # the tiered fast path (per-shard plans, unified statics)
    sa16 = partition(a, n_devices, align=16)
    u2 = sharded_spmv_prepared(prepare_sharded(sa16), v, mesh)

    # the sharded product: task-SELL numeric + selective B-tile exchange
    sb16 = partition(bt, n_devices, align=16)
    spp = prepare_sharded_product(sa16, sb16)
    c_fast = sharded_multiply(spp, mesh).to_bmsparse()

    a_sp = a.to_scipy().tocsr()
    v_np = v.cpu().double().numpy()
    ref = (a_sp @ a_sp) @ v_np
    np.testing.assert_allclose(u.cpu().numpy(), ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(u2.cpu().numpy(), a_sp @ v_np, rtol=1e-3,
                               atol=1e-4)
    c_err = float(np.abs(c_fast.to_scipy().toarray()
                         - (a_sp @ a_sp).toarray()).max())
    if not c_err < 1e-3:
        raise RuntimeError(f"sharded product fast path err {c_err}")

    # a production-scale shard: the 262,144-row band through the halo
    big, vbig = big_band(dev)
    spb = prepare_sharded(partition(big, n_devices, align=16))
    u3 = sharded_spmv_prepared(spb, vbig, mesh)
    ref3 = big.to_scipy() @ vbig.cpu().double().numpy()
    err3 = float(np.max(np.abs(u3.cpu().numpy() - ref3))
                 / max(float(np.max(np.abs(ref3))), 1e-30))
    if not err3 < 1e-3:
        raise RuntimeError(f"256k-row sharded SpMV err {err3}")

    u_err = float(np.max(np.abs(u.cpu().numpy() - ref)))
    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}, {dev.type}): OK (max |u| err "
              f"{u_err:.2e}; fast-path C err {c_err:.2e}; selective "
              f"exchange {spp.comm_bytes_selective}/"
              f"{spp.comm_bytes_allgather} B; 256k-row halo "
              f"{spb.halo} SpMV rel err {err3:.2e})")
    return dict(u=u.cpu().numpy(), u2=u2.cpu().numpy(),
                c=c_fast.generate_coo(), u3=u3.cpu().numpy(),
                u_err=u_err, c_err=c_err, err3=err3, halo=spb.halo,
                comm_bytes_selective=spp.comm_bytes_selective,
                comm_bytes_allgather=spp.comm_bytes_allgather)


def dryrun_rank(mesh) -> dict:
    """run_ranks entry: the dry run on the launched mesh."""
    return dryrun_multichip(mesh.size, mesh.device.type)
