"""flat_roofline: the exact flat scan's bound time over its device time, in
percent. Its kernels: the queries' bf16 rounding, pass 1 (the tensor-core
scan, or the SIMT scan of f32 stores), the merge. Its bound, a traced
request: every row's bf16 bytes once, the f32 queries, the result; a
multiply-add a dimension of every row for every query at the bf16 tensor
rate. Counted from the published rows and dims, not from the padding, so
the count is the same whatever implements the scan."""

from portbench import roofline

KERNELS = [r"\bround_queries_kernel\b", r"\bscan_wgmma_kernel\b", r"\bscan_f32_kernel\b",
           r"\bmerge_kernel\b"]


# the stage ran only where its scan did (the merge serves other stages too)
SCAN = [r"\bscan_wgmma_kernel\b", r"\bscan_f32_kernel\b"]


def read(t):
    dev_s = t.kernel_seconds(KERNELS)
    sh = t.inputs.get("shape", {})
    if t.kernel_seconds(SCAN) <= 0 or not t.requests or "n" not in sh:
        return None
    b, n, d, k = sh["b"], sh["n"], sh["d"], sh["k"]
    bound = roofline.bound_ms(n * d * 2 + b * d * 4 + b * k * 8, 2.0 * b * n * d, "bf16")[0]
    return 100.0 * len(t.requests) * bound / (dev_s * 1e3)
