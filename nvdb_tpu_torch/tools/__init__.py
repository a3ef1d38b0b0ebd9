"""CLI tools of the port (``python -m nvdb_tpu_torch.tools.<name>``):

reference binary        ->  tool
-----------------------------------
nvdb_bench              ->  bench
nvdb_ivfpq_build        ->  ivf_build (--kind ivfpq)
nvdb_ivf_eval           ->  ivf_eval

The other tools of ``nvdb_tpu.tools`` arrive with later slices.
"""
