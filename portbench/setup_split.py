"""A cell's set-up split by part, outside any benchmark run:
``python3 -m portbench.setup_split [--cell ivfpq1536.b256] [--seed N]``
from the root of the repo, on a card.

It runs the set-up ``portbench.run`` times as ``setup_s`` (the corpus and
the query pool made on the card, the corpus copied to the host, the index
adapter's build and stores, the warm-up requests) with the program's spans
recorded (``eval/trace.py``) around the adapter, and prints the seconds of
each part and of each ``build.*`` span the program records, with its
attrs, and the adapter's peak device memory, then one JSON line. A program
that records no ``build.*`` span prints the parts alone."""

import argparse
import json
import sys
import time

from portbench import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="ivfpq1536.b256")
    ap.add_argument("--seed", type=int, default=2800000001)
    args = ap.parse_args(argv)

    import torch

    from nvdb_tpu_torch.eval import trace

    if not torch.cuda.is_available():
        print("error: the set-up split runs on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.cell)
    cfg, mix = cell.config, cell.traffic
    parts = {}

    def part(name, t0):
        torch.cuda.synchronize(dev)
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    corpus, pool = run.make_data(cfg, mix, args.seed, dev)
    t = part("data", t)
    rows = corpus.cpu().numpy()
    pool = pool.cpu()
    del corpus
    t = part("to_host", t)
    torch.cuda.reset_peak_memory_stats(dev)
    with trace.recording() as rec:
        served = spec.index_adapter(cfg["index"]["kind"]).Served(cfg, rows, args.seed, dev)
    t = part("adapter", t)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    batch = int(mix["batch"])
    for r in range(run.WARMUP_REQUESTS):
        off = r * batch % int(mix["pool"])
        v, i = served.search(pool[off:off + batch].to(dev))
        v.cpu(), i.cpu()
    part("warmup", t)
    stages = [{"name": r.name, "s": (r.end_ns - r.start_ns) / 1e9, **r.attrs}
              for r in rec.records if r.name.startswith("build.")]
    if stages:
        parts["build"] = (max(r.end_ns for r in rec.records if r.name.startswith("build."))
                          - min(r.start_ns for r in rec.records
                                if r.name.startswith("build."))) / 1e9
        parts["adapter_outside_build"] = parts["adapter"] - parts["build"]
    for name, s in parts.items():
        print(f"[setup_split] {args.cell} {name} {s:.3f} s", file=sys.stderr)
    print(f"[setup_split] {args.cell} the adapter's peak device memory {peak_gib:.3f} GiB",
          file=sys.stderr)
    for st in stages:
        print(f"[setup_split]   {st['name']} {st['s']:.3f} s rows={st['rows']} "
              f"where={st['where']} h2d_bytes={st['h2d_bytes']} d2h_bytes={st['d2h_bytes']}",
              file=sys.stderr)
    print(json.dumps({"cell": args.cell, "seed": args.seed, "parts_s": parts,
                      "adapter_peak_gib": peak_gib, "build": stages,
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
