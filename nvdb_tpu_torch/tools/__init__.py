"""CLI tools of the port (``python -m nvdb_tpu_torch.tools.<name>``):

reference binary        ->  tool
-----------------------------------
nvdb_bench              ->  bench
nvdb_ivf_build          ->  ivf_build (--kind ivfflat; --repack-from, --corpus-refine)
nvdb_ivfpq_build        ->  ivf_build (--kind ivfpq; --repack-from [--replicas R])
nvdb_ivf_eval           ->  ivf_eval
nvdb_quantize_i8        ->  quantize_i8 (--residual: the residual-int8 refine store)
nvdb_hnsw_build         ->  pr_build   (partition-then-rerank replaces HNSW)
nvdb_hnsw_search        ->  pr_search
nvdb_hnsw_eval          ->  pr_eval
nvdb_gt_build           ->  gt_build   (device, --row-chunk, --host)
nvdb_search             ->  search
nvdb_convert_f16        ->  convert_bf16 (--f16: IEEE half)
nvdb_slice              ->  slice
nvdb_dump               ->  dump
nvdb_sanity             ->  sanity
nvdb_make_query         ->  make_query
build_vecbin_chunked.py ->  synth (synthetic corpora), embed (text -> vecbin)
Performance_CUDA.md A/B ->  ab_compare
nvdb_cuda_sanity        ->  gpu_sanity
scripts/hbm_probe.py    ->  hbm_probe  (the card's HBM stream ceiling)

Every tool takes ``--device cuda|cpu`` and ``--backend auto|cuda|torch``; the
file tools (convert_bf16, slice, dump, sanity, synth, make_query) run on the
host whatever they say.
"""
