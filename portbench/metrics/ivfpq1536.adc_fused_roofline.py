"""ivfpq1536.adc_fused_roofline: ``adc_fused_roofline`` read in the cell
ivfpq1536.b256, the same kernels and bound: its ``read``, loaded from its
file."""

from portbench import spec

read = spec.load_module(spec.HERE / "metrics" / "adc_fused_roofline.py",
                        "portbench_metric_adc_fused_roofline").read
