"""The fused ADC key scan timed at the shape of a benchmark cell, outside
any benchmark run: ``python3 -m portbench.adc_cell [--cell ivfpq.b256]
[--seed N]`` from the root of the repo, on a card.

It builds the cell's index as a run builds it (the corpus generator and
the index adapter of its configuration, from ``--seed``), takes one batch
of its query pool, rotates and ranks it as ``search_device`` does, and
hands the batch to ``chip_smoke.fused_times``: the fused key scan with its
query-term pass at the batch, 8 and 1 queries, beside the table kernel and
key scan it replaces, the gather site, its bound, the chunk sweep and the
call by part (the ``NVDB_ADC_ABLATE`` builds). The kernels are those of
the checkout it runs in. Prints ``chip_smoke``'s lines, then one JSON line.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CELL = "ivfpq.b256"
SEED = 3000002501


def cell_batch(torch, dev, cell_name, seed):
    """(index, rotated queries [B, Dp], probes [B, P] int32, kk, fills) of
    one batch of the cell ``cell_name``, built from ``seed``."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.kernels import ops

    from portbench import run, spec

    cell = spec.load_cell(cell_name)
    cfg, mix = cell.config, cell.traffic
    corpus, pool = run.make_data(cfg, mix, seed, dev)
    served = spec.index_adapter(cfg["index"]["kind"]).Served(cfg, corpus.cpu().numpy(), seed,
                                                             dev)
    del corpus
    idx = served.idx
    b, nprobe = int(mix["batch"]), min(int(cfg["search"]["nprobe"]), idx.nlist)
    q = torch.zeros((b, idx.centroids.shape[1]), device=dev)
    q[:, :pool.shape[1]] = pool[:b]
    ops.no_tf32()
    q_rot = (q @ idx.rotation if idx.rotation is not None else q).contiguous()
    fills = idx.fills()
    probes = _coarse_probes(q_rot, idx.centroids, idx.slot_ids, nprobe,
                            terms=idx.coarse_terms()).to(torch.int32)
    return idx, q_rot, probes, max(served.k, served.refine_k), fills


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=CELL)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from nvdb_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    jobs = [("adc_topk", ()), ("adc_tables", ())] + [
        ("adc_topk", defines) for _, defines in chip_smoke.FUSED_ABLATIONS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        infos = list(ex.map(lambda job: _build.build(*job), jobs))
    print(f"built {len(infos)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for (name, defines), info in zip(jobs, infos):
        print(f"  {name} {' '.join(defines)}: {info['seconds']:.1f} s", flush=True)
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)
    t0 = time.perf_counter()
    idx, q_rot, probes, kk, fills = cell_batch(torch, dev, args.cell, args.seed)
    print(f"{args.cell}: index built in {time.perf_counter() - t0:.1f} s (seed {args.seed}): "
          f"nlist {idx.nlist}, M {idx.m}, dsub {idx.codebooks.shape[2]}, Lcap {idx.lcap}; B "
          f"{q_rot.shape[0]}, P {probes.shape[1]}, kk {kk}", flush=True)
    res = chip_smoke.fused_times(torch, dev, idx, q_rot, probes, kk, fills)
    print(json.dumps({"cell": args.cell, "seed": args.seed, "adc": res}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
