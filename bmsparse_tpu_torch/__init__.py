"""bmsparse_tpu_torch — the bmSparse framework in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100). A port of ``bmsparse_tpu`` (JAX on
a TPU), which stays the reference: module paths match, so each function's
counterpart is found by name.

Public API:
    BmSparse, CSRMatrix           — containers
    coo_to_bmsparse, csr_to_bmsparse, bmsparse_to_coo, bmsparse_to_csr,
    transpose
    read_matrix_market, mmread_bmsparse, save_bmsparse, load_bmsparse
    prepare (ops.plan)            — tiered per-matrix SpMV plan
    spmv, csr_spmv                — u = A @ v
    spgemm                        — C = A @ B (ops.spgemm)
    prepare_product               — cached C = A @ B per structure
    prepare_galerkin              — cached A_c = P^T (A P) per structure
                                    (an AMG level's re-set-up)
    mean_relative_error           — reference `compare()` semantics

Kernels (csrc/, built with nvcc at first use on a CUDA device):
    dia_spmv     (ops/cuda/spmv_kernel.py) — the DIA tier
    sell_window  (ops/cuda/sell_kernel.py) — windowed SELL groups, from
                 their packs (SellPack)
    numeric_sell (ops/cuda/spgemm_kernel.py) — SpGEMM task-SELL products
    numeric_window (ops/cuda/spgemm_window_kernel.py) — SpGEMM products
                 of K-groups with tile windows
    window_product, rowwise_gather (ops/cuda/shuffle_kernel.py) — the
                 stream tier's v gather and routing stages
    segment_compress_class (ops/cuda/compress_kernel.py) — the SpGEMM
                 segment compress (spgemm_compress="mxu")
"""

from .config import BLOCK_HEIGHT, BLOCK_SIZE, BLOCK_WIDTH, get_config, set_config
from .format.bmsparse import BmSparse
from .format.convert import (
    CSRMatrix,
    bmsparse_to_coo,
    bmsparse_to_csr,
    coo_to_bmsparse,
    csr_to_bmsparse,
    transpose,
)
from .io.binary import load_bmsparse, save_bmsparse
from .io.matrix_market import mmread_bmsparse, read_matrix_market
from .oracle.compare import assert_allclose_sparse, mean_relative_error
from .ops.plan import Prepared, prepare
from .ops.galerkin import prepare_galerkin
from .ops.product import prepare_product
from .ops.spgemm import spgemm
from .ops.spmv import csr_spmv, spmv

__version__ = "0.1.0"
