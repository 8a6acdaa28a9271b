"""Speed-of-light models for SpMV and SpGEMM on an NVIDIA card —
counterpart of ``bmsparse_tpu/utils/roofline.py``.

Both are bound by device-memory bytes at realistic sparsities. The SpMV
model charges the least traffic any implementation needs: every nonzero
value read once and the output vector written once (the input vector and
the structure are left uncharged, as in the JAX package). The SpGEMM
model is the JAX package's, copied unchanged.
"""

from __future__ import annotations

# Peak device-memory bandwidth, GB/s, from NVIDIA's data sheets, looked
# up by a substring of torch.cuda.get_device_name(); the first match wins.
_DEVICE_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 NVL", 3900.0),
    ("H100", 3350.0),        # SXM5, 80 GB HBM3
    ("H200", 4800.0),
)


def device_hbm_gbps(name: str) -> float | None:
    """Peak bandwidth of the card called `name`, or None if unknown."""
    for key, bw in _DEVICE_GBPS:
        if key in name:
            return bw
    return None


def spmv_min_bytes(nnz: int, nb: int, num_rows: int, num_cols: int,
                   value_bytes: int = 4) -> int:
    """Least device-memory traffic of one SpMV: every nonzero value read
    once and the output vector written once."""
    return nnz * value_bytes + num_rows * value_bytes


def spmv_min_bytes_values_only(nnz: int, value_bytes: int = 4) -> int:
    """The values-only floor: every nonzero value read once."""
    return nnz * value_bytes


def spgemm_min_bytes(
    nnz_a: int, nb_a: int, nnz_b: int, nb_b: int,
    num_tasks: int, nnz_c: int, nb_c: int, value_bytes: int = 4
) -> int:
    """Least traffic of the numeric SpGEMM phase: each task reads two
    blocks (values + bitmap metadata, charged once per task since gather
    locality is data-dependent), C written once."""
    per_block_meta = 8 + 4 + 4
    avg_a = max(nnz_a / max(nb_a, 1), 1.0)
    avg_b = max(nnz_b / max(nb_b, 1), 1.0)
    task_bytes = num_tasks * (
        (avg_a + avg_b) * value_bytes + 2 * per_block_meta + 8
    )
    return int(task_bytes + nnz_c * 4 + nb_c * per_block_meta)


def roofline_nnz_per_s(min_bytes: int, nnz: int, bw_gbps: float) -> float:
    secs = min_bytes / (bw_gbps * 1e9)
    return nnz / secs
