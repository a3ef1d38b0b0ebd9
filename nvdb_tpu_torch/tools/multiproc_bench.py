"""Timed two-process sharded serving (the port of
``scripts/multiproc_bench.sh``): what the cross-process runtime costs.

    python -m nvdb_tpu_torch.tools.multiproc_bench [--n 65536] [--dim 256]
        [--q 512] [--k 10] [--nlist 128] [--pq-m 32] [--nprobe 16] [--refine-k 64]
        [--batch-q 64] [--work DIR] [--out FILE] [--device cuda|cpu]

The same data, index and sharded search (``ShardedIVFPQIndex`` and the
sharded refine over a mesh of two row shards), two runtimes:

- A, ``runtime=1proc``: one process, ``tools.ivf_eval --shards 2
  --chained`` over two shards of one device (``--one-device``; two CPU
  shards with ``--device cpu``): the partials merge in the process;
- B, ``runtime=2proc``: two ranks of one shard each, ``tools.ivf_eval``
  started by ``dist._worker.run_ranks`` on a localhost coordinator
  (``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID``), the partials
  crossing between the processes over ``torch.distributed`` (``gloo`` when
  both ranks share one card, as NCCL refuses two ranks on one device).

B's delta over A bounds the cross-process transport. The files are the
script's: ``tools.synth --hard 24 --seed 1`` (N x dim), ``tools.make_query
--q Q --perturb 0.05``, ``tools.gt_build``, ``tools.ivf_build --kind ivfpq
--nlist --pq-m --train N``, in ``--work`` (default a temporary directory,
removed at the end). Prints arm A's RESULT line with ``runtime=1proc`` and
rank 0's with ``runtime=2proc``; ``--out FILE`` also writes them there (the
script's ``tee``). ``main`` returns the two records (dicts, their values as
printed). A rank that fails, or a rank's missing RESULT line, exits 1. It
runs on the card unless ``--device cpu`` is given; without a card it exits 1.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile

from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device


def parse_result(line: str) -> dict:
    """A RESULT line's key=value pairs, values as printed."""
    return dict(kv.split("=", 1) for kv in line.split()[1:])


def build_files(work: str, args, dev_args) -> dict:
    """The script's corpus, queries, ground truth and index in ``work``."""
    from nvdb_tpu_torch.tools import gt_build, ivf_build, make_query, synth

    f = {name: os.path.join(work, name) for name in
         ("base.vecbin", "q.vecbin", "gt.gtbin", f"ivfpq_{args.nlist}.npz")}
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        synth.main([f["base.vecbin"], "--count", str(args.n), "--dim", str(args.dim),
                    "--hard", "24", "--seed", "1"])
        make_query.main([f["base.vecbin"], f["q.vecbin"], "--q", str(args.q),
                         "--perturb", "0.05"])
        gt_build.main([f["base.vecbin"], f["q.vecbin"], f["gt.gtbin"], "--k", str(args.k)]
                      + dev_args)
        ivf_build.main([f["base.vecbin"], f[f"ivfpq_{args.nlist}.npz"], "--kind", "ivfpq",
                        "--nlist", str(args.nlist), "--pq-m", str(args.pq_m), "--train",
                        str(args.n)] + dev_args)
    return f


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--q", type=int, default=512)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nlist", type=int, default=128)
    p.add_argument("--pq-m", type=int, default=32)
    p.add_argument("--nprobe", type=int, default=16)
    p.add_argument("--refine-k", type=int, default=64)
    p.add_argument("--batch-q", type=int, default=64)
    p.add_argument("--work", default=None,
                   help="directory for the files (default: a temporary one, removed)")
    p.add_argument("--out", default=None, help="also write the RESULT lines here")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds each rank of arm B may take")
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.dist import _worker
    from nvdb_tpu_torch.tools import ivf_eval

    dev_args = ["--device", args.device]
    work = args.work or tempfile.mkdtemp(prefix="nvdb_mp_")
    os.makedirs(work, exist_ok=True)
    try:
        f = build_files(work, args, dev_args)
        eval_args = [f[f"ivfpq_{args.nlist}.npz"], f["base.vecbin"], f["q.vecbin"], "--gt",
                     f["gt.gtbin"], "--k", str(args.k), "--nprobe", str(args.nprobe),
                     "--refine-k", str(args.refine_k), "--batch-q", str(args.batch_q),
                     "--chained", "--shards", "2"] + dev_args + ["--backend", args.backend]
        print("=== A: one process, two shards of one device ===", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ivf_eval.main(eval_args + ([] if device.type == "cpu" else ["--one-device"]))
        lines = [ln + " runtime=1proc" for ln in buf.getvalue().splitlines()
                 if ln.startswith("RESULT")]
        print("\n".join(lines), flush=True)
        print("=== B: two processes, one shard each, torch.distributed ===", flush=True)
        runs = _worker.run_ranks(eval_args, nproc=2, timeout=args.timeout,
                                 module="nvdb_tpu_torch.tools.ivf_eval")
        for rank, (rc, text) in enumerate(runs):
            if rc != 0:
                fail(f"rank {rank} exited {rc}:\n{text[-4000:]}")
        rank0 = [ln + " runtime=2proc" for ln in runs[0][1].splitlines()
                 if ln.startswith("RESULT")]
        if not lines or not rank0:
            fail("a runtime printed no RESULT line")
        print("\n".join(rank0), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write("\n".join(lines + rank0) + "\n")
        return [parse_result(lines[0]), parse_result(rank0[0])]
    finally:
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
