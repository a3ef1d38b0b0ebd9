"""CLI tools of the port (``python -m nvdb_tpu_torch.tools.<name>``):

reference binary        ->  tool
-----------------------------------
nvdb_bench              ->  bench

The other tools of ``nvdb_tpu.tools`` arrive with later slices.
"""
