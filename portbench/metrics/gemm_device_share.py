"""Share of the profiled slice's device time in cuBLAS or CUTLASS matrix
products (kernel names holding gemm, gemv or cutlass): the stacked heads'
batched products and the Gram path's quadratic form."""

import re

GEMM = re.compile(r"gemm|gemv|cutlass", re.IGNORECASE)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    total = sum(e.dur_us for e in tr.device)
    gemm = sum(e.dur_us for e in tr.device if GEMM.search(e.name))
    return 100.0 * gemm / total if total > 0 else None
