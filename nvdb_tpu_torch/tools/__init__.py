"""CLI tools of the port (``python -m nvdb_tpu_torch.tools.<name>``):

reference binary        ->  tool
-----------------------------------
nvdb_bench              ->  bench
nvdb_ivf_build          ->  ivf_build (--kind ivfflat)
nvdb_ivfpq_build        ->  ivf_build (--kind ivfpq)
nvdb_ivf_eval           ->  ivf_eval
nvdb_quantize_i8        ->  quantize_i8 (--residual: the residual-int8 refine store)
nvdb_hnsw_build         ->  pr_build   (partition-then-rerank replaces HNSW)
nvdb_hnsw_search        ->  pr_search
nvdb_hnsw_eval          ->  pr_eval
nvdb_cuda_sanity        ->  gpu_sanity
scripts/hbm_probe.py    ->  hbm_probe  (the card's HBM stream ceiling)

The other tools of ``nvdb_tpu.tools`` arrive with later slices.
"""
