"""Shared CLI plumbing for the tools."""

from __future__ import annotations

import argparse
import sys


def make_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device that holds the store (default cuda; without a "
                        "card the tool fails unless cpu is asked for)")
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "torch"],
                   help="scan backend (auto: the CUDA kernel on a card, plain "
                        "torch on the CPU; torch: plain torch anywhere)")
    return p


def setup_device(args):
    """The torch device the tool runs on. Exits non-zero when CUDA is asked
    for and there is no card: a measurement never falls back to the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device; pass --device cpu to run on the CPU")
    return torch.device(args.device)


def tool_mesh(args, n_rows: int):
    """The tools' row mesh: ``n_rows`` visible cards, or ``n_rows`` CPU
    shards with ``--device cpu``. Exits non-zero, naming the shortfall,
    when there are fewer cards (as the JAX tools' ``row_mesh`` does on one
    device)."""
    import torch

    from nvdb_tpu_torch.dist.mesh import row_mesh

    try:
        return row_mesh(n_rows, devices=([torch.device("cpu")] * n_rows
                                         if args.device == "cpu" else None))
    except ValueError as e:
        fail(str(e))


def fail(msg: str, code: int = 1):
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(code)
