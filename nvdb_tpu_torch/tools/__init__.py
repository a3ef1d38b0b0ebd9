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
scripts/kernel_ab.py    ->  kernel_ab  (paired A/B of the flat scan: kernel, simt,
                                        library, plain)
scripts/refine_ab.py    ->  refine_ab  (the rerank kernel against the gather path)
scripts/adc_ab.py       ->  adc_ab     (gen4 / gen5 / gen6: the ADC id modes)
scripts/coverage_probe.py -> coverage_probe (probe coverage against nprobe)
scripts/adc_rank_probe.py -> adc_rank_probe (P(ADC rank <= rk | covered))
scripts/multiproc_bench.sh -> multiproc_bench (one process against two ranks)

Every tool takes ``--device cuda|cpu`` and ``--backend auto|cuda|torch``; the
file tools (convert_bf16, slice, dump, sanity, synth, make_query) run on the
host whatever they say. Every tool joins the process group that
``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID`` name (``_common.setup_device``),
so the ``--shards`` of bench, ivf_eval and pr_eval span the processes. The
A/B tools share ``_ab``'s paired timer.
"""
