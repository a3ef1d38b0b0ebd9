"""ivfpq1536.plain_torch_ms: ``index.plain_torch_ms`` read in the cell
ivfpq1536.b256 (the 1536-dim rotation, the coarse product over 8192 lists
and its top-64, the glue): its ``read``, loaded from its file."""

from portbench import spec

read = spec.load_module(spec.HERE / "metrics" / "index.plain_torch_ms.py",
                        "portbench_metric_index_plain_torch_ms").read
