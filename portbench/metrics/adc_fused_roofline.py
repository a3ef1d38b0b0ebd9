"""adc_fused_roofline: the fused ADC key scan's bound time over its device
time, in percent. Its kernels: pass 0 (the list grouping), the fused scan,
the merge. Its bound: ``roofline.adc_fused_bound`` of each traced request,
from the probe sets of the reference's coarse ranking and the list fills."""

from portbench import roofline

KERNELS = [r"\bgroup_pairs_kernel\b", r"\badc_fused_kernel\b", r"\badc_merge_keys_kernel\b"]


# the stage ran only where its scan did (pass 0 serves other stages too)
SCAN = [r"\badc_fused_kernel\b"]


def read(t):
    dev_s = t.kernel_seconds(KERNELS)
    if (t.kernel_seconds(SCAN) <= 0 or "probes" not in t.inputs
            or "codebooks_numel" not in t.inputs.get("shape", {})):
        return None
    sh = t.inputs["shape"]
    c = {key: v.tolist() for key, v in roofline.probe_counts(
        t.inputs["probes"], t.inputs["fills"], t.inputs["nlist"]).items()}
    bound = sum(roofline.adc_fused_bound(
        {key: v[j] for key, v in c.items()}, sh["b"], sh["p"], sh["m"], sh["dsub"],
        sh["dp"], sh["kk"], sh["codebooks_numel"]) for j in range(len(c["pairs"])))
    return 100.0 * bound / (dev_s * 1e3)
