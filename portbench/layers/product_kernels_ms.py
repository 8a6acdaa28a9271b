"""product_kernels_ms: device ms per product inside the program's two
product kernels (numeric_window and numeric_sell, one template in
csrc/spgemm_tiles.cuh), from the traced window of whole requests. The
rest of the busy time is the operands' decompress and C's compress."""

KERNEL = r"chunk_products<"


def read(rec):
    w = rec.window("requests")
    if w is None:
        return None
    return w.kernel_seconds(KERNEL) / w.calls * 1e3
