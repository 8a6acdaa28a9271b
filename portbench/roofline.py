"""The benchmark's frozen yardstick: the card's data-sheet peaks and the
least work of one SpMV and of one SpGEMM, counted from the matrix alone.

A later change to the program cannot move these numbers: they live here,
beside the benchmark, and read only sizes of the matrices (nnz, shape, the
row and column counts that fix A·A's scalar products), never the
program's plan.
"""

from __future__ import annotations

# Peak device-memory bandwidth, GB/s, from NVIDIA's data sheets, looked up
# by a substring of torch.cuda.get_device_name(); the first match wins.
DEVICE_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 NVL", 3900.0),
    ("H100", 3350.0),        # SXM5, 80 GB HBM3
    ("H200", 4800.0),
)

# Peak float32 rate outside the tensor cores, TFLOP/s, dense (data sheets).
DEVICE_F32_TFLOPS = (
    ("H100 PCIe", 51.0),
    ("H100 NVL", 60.0),
    ("H100", 67.0),          # SXM5
    ("H200", 67.0),
)


def _lookup(table, name: str) -> float | None:
    for key, value in table:
        if key in name:
            return value
    return None


def device_gbps(name: str) -> float | None:
    """Data-sheet bandwidth of the card called `name`, or None."""
    return _lookup(DEVICE_GBPS, name)


def device_f32_tflops(name: str) -> float | None:
    """Data-sheet float32 rate of the card called `name`, or None."""
    return _lookup(DEVICE_F32_TFLOPS, name)


def spmv_least_bytes(nnz: int, n_rows: int, n_cols: int,
                     value_bytes: int = 4) -> int:
    """Least device-memory traffic of u = A @ v: every nonzero value read
    once, v read once, u written once.

    The program's own model (`utils/roofline.py::spmv_min_bytes`) leaves
    v uncharged; it is read at least once by any implementation, and at
    HPCG's 104³ grid it is 3.6% of the bytes. Indices are not charged: a
    format may derive them (a stencil needs none), so they are no floor.
    """
    return (nnz + n_rows + n_cols) * value_bytes


def spgemm_products(a_col_counts, b_row_counts) -> int:
    """Scalar multiply-adds of C = A @ B: the sum over k of nnz(A[:, k])
    times nnz(B[k, :]), from two integer tensors of equal length."""
    return int((a_col_counts.long() * b_row_counts.long()).sum())


def spgemm_least_bytes(nnz_a: int, nnz_b: int, nnz_c: int,
                       value_bytes: int = 4) -> int:
    """Least traffic of one product with a known structure: A and B read
    once, C written once.

    The program's `utils/roofline.py::spgemm_min_bytes` charges every task
    its two blocks, which is the traffic of the block-task algorithm, not
    the least any implementation needs; that count moves when the program
    changes its tasks, so it is no yardstick.
    """
    return (nnz_a + nnz_b + nnz_c) * value_bytes


def least_seconds(bytes_: int, flops: int, card: str) -> tuple[float, str]:
    """The least time of work of `bytes_` and `flops` on the card named
    `card`: the larger of bytes at the data-sheet bandwidth and FLOPs at
    the float32 peak, with the name of the bound. Raises for a card
    missing from the tables: a share of an unknown peak is no number."""
    gbps, tflops = device_gbps(card), device_f32_tflops(card)
    if gbps is None or tflops is None:
        raise KeyError(f"no data-sheet peak for the card {card!r}")
    t_bytes = bytes_ / (gbps * 1e9)
    t_flops = flops / (tflops * 1e12)
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
