"""Shared CLI plumbing for the tools."""

from __future__ import annotations

import argparse
import sys


def make_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device that holds the store (default cuda; without a "
                        "card the tool fails unless cpu is asked for)")
    p.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                   help="the same as --device cpu (the JAX tools' name)")
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "torch"],
                   help="scan backend (auto: the CUDA kernel on a card, plain "
                        "torch on the CPU; torch: plain torch anywhere)")
    p.add_argument("--debug-nans", action="store_true",
                   help="check every query, payload and score tensor at the kernel "
                        "seams and exit non-zero naming the first stage that holds a "
                        "NaN or an infinity (the counterpart of jax_debug_nans)")
    return p


def setup_device(args):
    """The torch device the tool runs on. Exits non-zero when CUDA is asked
    for and there is no card: a measurement never falls back to the CPU.
    Sets ``dispatch.DEBUG_NANS`` from ``--debug-nans``.

    Multi-process entry, as the JAX tools' ``setup_jax``: a no-op unless
    ``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID`` are set; the tool
    then joins the process group before its first use of a device (over
    ``gloo`` with ``--device cpu``) and prints ``process_summary`` to
    stderr, and its sharded paths span the processes (``tool_mesh``)."""
    import torch

    from nvdb_tpu_torch.dist import multihost
    from nvdb_tpu_torch.kernels import dispatch

    dispatch.DEBUG_NANS = bool(getattr(args, "debug_nans", False))
    if args.device == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device; pass --device cpu to run on the CPU")
    if multihost.init_from_env(backend="gloo" if args.device == "cpu" else None):
        print(f"# {multihost.process_summary()}", file=sys.stderr)
    if args.device == "cuda" and multihost.joined():
        return multihost.local_device()
    return torch.device(args.device)


def tool_mesh(args, n_rows: int):
    """The tools' row mesh of ``n_rows`` shards: ``n_rows`` visible cards,
    or ``n_rows`` CPU shards with ``--device cpu``. In a process group
    (``setup_device``) the mesh spans the processes
    (``multihost.global_row_mesh``): each holds ``n_rows / world`` shards,
    on its own card (``multihost.local_device``) repeated, or on the CPU.
    With ``--one-device`` every shard of this process is on its one card.
    Exits non-zero, naming the shortfall, when there are fewer cards (as
    the JAX tools' ``row_mesh`` does on one device) or when the shards do
    not split over the processes."""
    import torch

    from nvdb_tpu_torch.dist import multihost
    from nvdb_tpu_torch.dist.mesh import row_mesh

    cpu = args.device == "cpu"
    try:
        if multihost.joined():
            import torch.distributed as dist

            world = dist.get_world_size()
            if n_rows % world != 0:
                fail(f"{n_rows} shards do not split over {world} processes")
            dev = torch.device("cpu") if cpu else multihost.local_device()
            mesh = multihost.global_row_mesh(devices=[dev] * (n_rows // world))
            print(f"# {multihost.process_summary(mesh)}", file=sys.stderr)
            return mesh
        if cpu or getattr(args, "one_device", False):
            dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
            return row_mesh(n_rows, devices=[dev] * n_rows)
        return row_mesh(n_rows)
    except ValueError as e:
        fail(str(e))


def fail(msg: str, code: int = 1):
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(code)
