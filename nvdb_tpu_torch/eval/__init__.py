from nvdb_tpu_torch.eval.stats import LatencyStats, percentile, compute_stats, result_line  # noqa: F401
from nvdb_tpu_torch.eval.recall import recall_at_k  # noqa: F401
