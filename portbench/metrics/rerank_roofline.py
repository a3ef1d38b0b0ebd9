"""rerank_roofline: the exact rerank kernel's bound time over its device
time, in percent; the bound, ``roofline.rerank_bound``, of each traced
request's candidates."""

from portbench import roofline

KERNELS = [r"\brerank_kernel\b"]


def read(t):
    dev_s = t.kernel_seconds(KERNELS)
    if dev_s <= 0 or not t.requests or "shape" not in t.inputs:
        return None
    sh = t.inputs["shape"]
    bound = len(t.requests) * roofline.rerank_bound(sh["b"], sh["r"], sh["dp"], sh["k"])
    return 100.0 * bound / (dev_s * 1e3)
