"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from process start): the corpus and the
query pool made on the card from the seed, the corpus copied to the host
for the build, the program's index built, every request shape warmed up.
The window: one client sends the cell's requests back to back (a closed
loop) for ``--seconds``; a request runs from the host's submit of its query
batch to its (scores, ids) on the host. After the window the program's
index is freed and the reference judges the answers (``reference.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the whole window), ``device`` and, traced, ``breakdown``; the numbers
compared come last, under ``checks``, each beside its limit, and again as
the last lines of standard error. Without a card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0."""

from __future__ import annotations

import time

_T_START = time.perf_counter()   # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import numpy as np  # noqa: E402

from portbench import queries, spec  # noqa: E402
from portbench.trace import HOST_PHASES  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nvdb_tpu")
CHECK_SAMPLE = 4096      # answers the reference judges, drawn from the seed
WARMUP_REQUESTS = 50


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def percentile(sorted_vals, p: float) -> float:
    """Interpolated percentile of pre-sorted samples (``pos = p/100 *
    (n-1)``, linear between neighbours): the reference's pct(), as
    ``eval/stats.py`` has it."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    pos = (p / 100.0) * (n - 1)
    i0 = int(pos)
    i1 = min(i0 + 1, n - 1)
    frac = pos - i0
    return sorted_vals[i0] * (1.0 - frac) + sorted_vals[i1] * frac


def _sub_seed(seed: int, salt: int) -> int:
    return ((seed & (2**60 - 1)) << 2) | salt


def make_data(cfg: dict, mix: dict, seed: int, device):
    """The corpus [n, dim] and the query pool [pool, dim], f32 on ``device``,
    from the seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(_sub_seed(seed, 0))
    corpus = spec.corpus_generator(cfg["corpus"]["generator"]).generate(
        cfg["corpus"], gen, device)
    qgen = torch.Generator(device=device).manual_seed(_sub_seed(seed, 1))
    return corpus, queries.make_pool(mix, corpus, qgen)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             served_factory: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result object. ``served_factory``
    (tests and the control) builds what serves the requests in place of the
    configuration's index adapter."""
    import torch

    cfg, mix = cell.config, cell.traffic
    queries.check_mix(mix)
    device = torch.device(device)
    cuda = device.type == "cuda"
    batch, pool_n = int(mix["batch"]), int(mix["pool"])

    # -- set-up ---------------------------------------------------------------
    t = time.perf_counter()
    corpus, pool = make_data(cfg, mix, seed, device)
    rows = corpus.cpu().numpy()
    pool_host = pool.cpu()
    del corpus, pool
    say(f"[portbench] corpus {rows.shape} and {pool_n} queries made and copied in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    factory = served_factory or spec.index_adapter(cfg["index"]["kind"]).Served
    served = factory(cfg, rows, seed, device)
    del rows
    say(f"[portbench] index built in {time.perf_counter() - t:.2f} s")
    order = queries.send_order(mix, seed)
    stream = pool_host[torch.from_numpy(order)]
    if cuda:
        stream = stream.pin_memory()

    fetched = {}   # pinned host buffers the answers come back to, made at warm-up

    def request(off: int):
        t_sub = time.perf_counter_ns()
        q = stream[off:off + batch].to(device, non_blocking=True)
        t_call = time.perf_counter_ns()
        v, i = served.search(q)
        t_ret = time.perf_counter_ns()
        if not cuda:
            return v.clone(), i.clone(), (t_sub, t_call, t_ret, time.perf_counter_ns())
        if "v" not in fetched:
            fetched["v"] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            fetched["i"] = torch.empty(i.shape, dtype=i.dtype, pin_memory=True)
        fetched["v"].copy_(v, non_blocking=True)
        fetched["i"].copy_(i, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        v, i = fetched["v"].clone(), fetched["i"].clone()
        return v, i, (t_sub, t_call, t_ret, time.perf_counter_ns())

    for r in range(WARMUP_REQUESTS):
        request(r * batch % pool_n)
    gc.collect()
    gc.freeze()   # the set-up's objects out of every later collection's walk
    _sync(device)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - _T_START
    say(f"[portbench] set-up {setup_s:.2f} s")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the window's host work is one client's
    host_before = host_load()

    # -- the window -----------------------------------------------------------
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    clock_offset = time.time_ns() - time.perf_counter_ns()   # profiler clock = time_ns
    offs, vals, ids, spans = [], [], [], []
    if prof is not None:
        prof.start()
    t_begin = time.perf_counter_ns()
    deadline = t_begin + int(seconds * 1e9)
    r = 0
    while time.perf_counter_ns() < deadline:
        off = r * batch % pool_n
        v, i, sp = request(off)
        offs.append(off)
        vals.append(v)
        ids.append(i)
        spans.append(sp)
        r += 1
    trace_end = spans[-1][3]
    torch.set_num_threads(threads)
    if prof is not None:
        prof.stop()
    window_s = (spans[-1][3] - t_begin) / 1e9
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_req = len(spans)
    lat_ms = sorted((s[3] - s[0]) / 1e6 for s in spans)
    sec = np.array([(s_[3] - t_begin) // 1_000_000_000 for s_ in spans])
    phase_us = np.diff(np.array(spans, dtype=np.int64), axis=1) / 1e3   # [requests, phases]
    say(f"[portbench] requests finished in each second of the window: "
        f"{np.bincount(sec).tolist()}; median us a phase in each second: "
        + ", ".join(f"{ph} {[round(float(np.median(phase_us[sec == j, c])), 1) for j in np.unique(sec)]}"
                    for c, ph in enumerate(HOST_PHASES)))
    say(f"[portbench] window {window_s:.3f} s, {n_req} requests of {batch}; host before "
        f"{host_before}, after {host_load()}; a request's host phases, median us: "
        + ", ".join(f"{ph} {np.median([(s_[j + 1] - s_[j]) / 1e3 for s_ in spans]):.1f}"
                    for j, ph in enumerate(HOST_PHASES)))

    # -- after the window: the program's state is freed, the reference judges --
    from portbench import reference

    state = served.state(seed)
    shape = served.shape(batch)
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    corpus, pool = make_data(cfg, mix, seed, device)
    if not torch.equal(pool.cpu(), pool_host):
        raise RuntimeError("the query pool made again from the seed differs from the first")
    se = cfg["search"]
    k = int(se["k"])
    truth = reference.exact_topk(corpus, pool, k, se["metric"])[1]
    asked = order[np.add.outer(np.asarray(offs), np.arange(batch))]   # [requests, batch]
    qidx = torch.from_numpy(asked.reshape(-1))
    got_i = torch.cat(ids)
    got_v = torch.cat(vals)
    recall = 0.0
    for s in range(0, qidx.numel(), 262_144):
        qi = qidx[s:s + 262_144].to(device)
        recall += float(reference.recall_at(got_i[s:s + 262_144].to(device), truth[qi], k).sum())
    recall /= qidx.numel()
    rng = np.random.default_rng([seed & (2**63 - 1), 3])
    pick = torch.from_numpy(np.sort(rng.choice(qidx.numel(), size=min(CHECK_SAMPLE, qidx.numel()),
                                               replace=False)))
    numbers = reference.judge(pool[qidx[pick].to(device)], got_v[pick], got_i[pick], corpus,
                              state, se)
    failed = int(numbers.pop("failed_rows"))
    numbers.update(reference.start_checks(corpus, state))
    say(f"[portbench] reference: truth, recall and checks in {time.perf_counter() - t:.2f} s")

    limits = cfg["limits"]
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"the configuration gives no limit for {missing}")
    checks = {name: {"value": numbers[name], "limit": float(limits[name])} for name in numbers}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": n_req * batch, "failed": failed}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        from portbench import trace as tr

        t0, t1 = t_begin + clock_offset, trace_end + clock_offset
        traced = [dict(zip(tr.HOST_PHASES, zip(sp[:-1], sp[1:])))
                  for sp in (tuple(x + clock_offset for x in s_) for s_ in spans)]
        t_tr = time.perf_counter()
        acts = tr.device_activities(prof) if cuda else []
        say(f"[portbench] trace read in {time.perf_counter() - t_tr:.2f} s")
        fills = ((state.slot_ids >= 0).long() * torch.arange(
            1, state.slot_ids.shape[1] + 1, device=state.slot_ids.device)).max(1).values
        probes = torch.topk(reference.coarse_scores(pool, state), int(shape["p"]), dim=1).indices
        tv = tr.Trace(activities=acts, requests=traced, t0_ns=t0, t1_ns=t1,
                      inputs={"probes": probes[torch.from_numpy(asked).to(probes.device)],
                              "fills": fills,
                              "nlist": state.slot_ids.shape[0], "shape": shape})
        readers = spec.metric_readers([m["name"] for m in cell.per_layer])
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(tv)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        busy = tv.busy_s()
        first = [a for a in acts if traced and a[1] <= traced[min(49, len(traced) - 1)]["fetch"][1]]
        inside = sum(1 for a in first if any(q["submit"][0] <= a[1] <= q["fetch"][1]
                                             for q in traced[:50]))
        say(f"[portbench] trace: {len(acts)} device activities, {len(traced)} requests, "
            f"busy {busy:.6f} s of {tv.window_s:.6f} s; of the first 50 requests' device "
            f"activities {inside} of {len(first)} lie inside their host spans")
        dev.update(busy_s=busy, window_s=tv.window_s)
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": tv.top_ops(10), "idle_gaps": tv.idle_gaps(10)}
    else:
        values = {"qps": n_req * batch / window_s, "latency_p90_ms": percentile(lat_ms, 90),
                  "recall_at_10": recall, "device_gib": peak / 2**30, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev
    say(f"[portbench] qps {n_req * batch / window_s:.3f}, p50 {percentile(lat_ms, 50):.4f} ms, "
        f"p90 {percentile(lat_ms, 90):.4f} ms, p99 {percentile(lat_ms, 99):.4f} ms, "
        f"recall@{k} {recall:.6f}, "
        f"peak {peak / 2**30:.4f} GiB, setup {setup_s:.3f} s")
    result["checks"] = checks
    return result


def host_load() -> str:
    """The host's mean core clock (MHz) and load average, for the log."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(x.split(":")[1]) for x in f if x.startswith("cpu MHz")]
        with open("/proc/loadavg") as f:
            load = f.read().split()[0]
        return f"{sum(mhz) / max(1, len(mhz)):.0f} MHz, load {load}"
    except (OSError, ValueError, IndexError):
        return "not readable"


def power_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"error: the cell needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    import nvdb_tpu_torch  # noqa: F401  (the program: fails here where it is absent)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    bad = forbidden_modules()
    if bad:
        say(f"error: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    say(f"[portbench] card: {power_line()}")
    for name, c in result["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
