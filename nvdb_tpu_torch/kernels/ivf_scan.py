"""IVF probe top-k: the wrapper of the CUDA kernel ``csrc/ivf_probe_topk.cu``
(the port of ``nvdb_tpu.kernels.ivf_scan.pallas_ivf_probe_topk``) and its
plain PyTorch version.

Both score slot l of probed list p = probes[b, p] by dot(q_b, packed[p, l])
(f32 slabs in full f32; bf16 and int8 slabs with the query rounded to bf16
and the slab widened, sums in f32, int8 sums times the slot's scale), mask
slots whose id is -1, and return the top k (k <= 128) by (score desc, id
desc) with (-inf, -1) fill. A probe id outside [0, nlist) is an empty list;
a list probed twice by one query scores twice.

``ivf_probe_topk_cuda`` launches the kernel on a CUDA tensor and raises on
any other. The kernel is list-major: the batch's (query, probe) pairs are
grouped by list on the device (``group_pairs_reference`` is the plain
version of that pass) and each probed list is read once for every chunk of
up to 8 queries that probe it.

``probe_bytes`` counts a batch's bytes both ways: as probed (a list once
for each pair that probes it) and distinct (each probed list once), the
latter being what a bound is reckoned from.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.kernels import ops
from nvdb_tpu_torch.kernels.adc_scan import list_fills
from nvdb_tpu_torch.kernels.flat_scan import check_tensor, require_cuda
from nvdb_tpu_torch.utils import cdiv, round_up

MAX_K = 128
_LIST_CTAS_PER_SM = 2  # list-major: below this many pairs a SM, lists split into row ranges
_LIST_RANGE_ROWS = 64  # list-major: the least rows a range holds (one tile)
_LIST_MAX_PARTIALS = 64  # list-major: row ranges stop where a query's P x R partials pass this
# list-major: the widest query chunk the plan may take, the pass-1 CTAs a SM
# it fits shared memory for, the ring's depth at most. chip_smoke.py phase 12
# times 8 / 16 / 32 queries at 2 and 3 CTAs a SM on an H100 (PERF.md):
# narrow chunks and more CTAs a SM keep more bytes in flight, and beat the
# fewer re-reads of a hot list that wide chunks save.
_LIST_NQ_MAX = 8
_LIST_PLAN_CTAS = 3
_LIST_MAX_STAGES = 16

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Launches of the kernel since the last reset. Only ivf_probe_topk_cuda's
# launch adds to it; ``index/graphs.py`` keeps it to the kernels that ran: a
# served chain's capture adds nothing, each replay adds its launches.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def ivf_probe_topk_reference(
    queries: torch.Tensor,              # [B, Dp] f32
    probes: torch.Tensor,               # [B, P] int list ids
    packed: torch.Tensor,               # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor,             # [nlist, Lcap] int32 (-1 padding)
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 (int8 slabs)
    k: int,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, chunked over queries so the
    gathered f32 slabs stay near 256 MB (unchunked, B = 256 queries of 64
    probes of 384 x 768 slabs would be 19 GB)."""
    B, P = probes.shape
    nlist, L, Dp = packed.shape
    if q_chunk is None:
        q_chunk = max(1, (256 << 20) // max(1, P * L * Dp * 4))
    ops.no_tf32()
    # f32 slabs take the query as it is, bf16 / int8 slabs a bf16-rounded one
    q_all = queries.to(torch.float32) if packed.dtype == torch.float32 else \
        ops._bf16_round(queries)
    probes = probes.long()
    vals, ids = [], []
    for s in range(0, B, q_chunk):
        pr = probes[s:s + q_chunk]                                # [c, P]
        ok = (pr >= 0) & (pr < nlist)
        pr = torch.where(ok, pr, 0)
        scores = torch.einsum("cd,cpld->cpl", q_all[s:s + q_chunk],
                              packed[pr].to(torch.float32))       # [c, P, L]
        if slot_scales is not None:
            scores = scores * slot_scales[pr]
        sids = torch.where(ok[:, :, None], slot_ids[pr], -1)      # [c, P, L]
        scores = torch.where(sids >= 0, scores, ops.NEG_INF)
        c = pr.shape[0]
        v, i = ops.topk_sorted(scores.reshape(c, -1), sids.reshape(c, -1), k)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def _valid_pairs(probes: torch.Tensor, fills: torch.Tensor) -> torch.Tensor:
    """[B * P] bool: the pair's probe is a list id with a live slot."""
    nlist = fills.shape[0]
    pr = probes.reshape(-1).long()
    ok = (pr >= 0) & (pr < nlist)
    return ok & (fills.long()[pr.clamp(0, nlist - 1)] > 0)


def group_pairs_reference(
    probes: torch.Tensor,   # [B, P] int list ids
    fills: torch.Tensor,    # [nlist] int32 (list_fills)
    q_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the list-major kernel's pass 0. Returns (order
    [n] int32: the indices b * P + p of the pairs whose probe is a list with
    a live slot, by list, each list's pairs in ascending order; items [m, 3]
    int32: (list, first position in order, pairs), each list's pairs cut
    into items of at most ``q_chunk``, by list). The kernel's pass gives the
    same items in another order (the lists with the longest live prefix
    first) and each list's pairs in the order its atomics give."""
    nlist = fills.shape[0]
    pr = probes.reshape(-1).long()
    j = torch.nonzero(_valid_pairs(probes, fills)).flatten()
    lists = pr[j]
    order = j[torch.sort(lists, stable=True).indices].to(torch.int32)
    counts = torch.bincount(lists, minlength=nlist)
    n_it = (counts + q_chunk - 1) // q_chunk
    offs = torch.cumsum(counts, 0) - counts
    lst = torch.repeat_interleave(torch.arange(nlist, device=probes.device), n_it)
    first = torch.repeat_interleave(torch.cumsum(n_it, 0) - n_it, n_it)
    step = (torch.arange(lst.numel(), device=probes.device) - first) * q_chunk
    items = torch.stack([lst, offs[lst] + step, torch.clamp(counts[lst] - step, max=q_chunk)],
                        dim=1).to(torch.int32)
    return order, items


def probe_bytes(probes: torch.Tensor, fills: torch.Tensor, row_bytes: int, nlist: int,
                dp: int = 0, k: int = 0) -> Dict[str, int]:
    """A probe batch's bytes, both ways. ``row_bytes``: a slot's payload
    (with its scale for int8 slabs); ``dp`` and ``k``: the padded dim of the
    f32 queries and the result's length. Returns ``as_probed`` (the live
    prefix of every valid (query, probe) pair: a list counted once for each
    pair that probes it, as a kernel that reads it once a pair moves it),
    ``distinct`` (each valid probed list's live prefix and its ids once,
    plus the queries, the probes (int32) and the result: what the bound is
    reckoned from), ``lists`` (distinct valid probed lists), ``pairs``
    (valid pairs) and ``rows`` (distinct live-prefix rows)."""
    B = probes.shape[0]
    pr = probes.reshape(-1).long()
    ok = (pr >= 0) & (pr < nlist)
    pr = pr[ok]
    fl = fills.long()
    live = fl[pr] > 0
    pr = pr[live]
    uniq = torch.unique(pr)
    rows = int(fl[uniq].sum())
    return {
        "as_probed": int(fl[pr].sum()) * row_bytes,
        "distinct": rows * (row_bytes + 4) + B * dp * 4 + probes.numel() * 4 + B * k * 8,
        "lists": int(uniq.numel()),
        "pairs": int(pr.numel()),
        "rows": rows,
    }


@functools.cache
def _lib():
    """The kernel library's C entries, built with nvcc at first call."""
    from nvdb_tpu_torch.kernels import _build

    return bind(_build.load("ivf_probe_topk"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entries' arguments on a build of the kernel library
    (the port's, or a measurement build of the same source)."""
    # list-major: 11 pointers, B, P, nlist, Lcap, Dp, k, R, nq, n_stages, U, mode, stream
    lib.nvdb_ivf_probe_topk_list.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    # probes, fills, iscratch, B, P, nlist, Lcap, nq, stream
    lib.nvdb_ivf_group_pairs.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.nvdb_ivf_probe_list_plan.argtypes = [ctypes.c_int] * 6 + \
        [ctypes.POINTER(ctypes.c_int)] * 2
    for fn in (lib.nvdb_ivf_probe_topk_list, lib.nvdb_ivf_group_pairs,
               lib.nvdb_ivf_probe_list_plan):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _list_plan(mode: int, dp: int, k: int, device_index: int, nq_max: int, ctas: int,
               max_stages: int) -> Tuple[int, int]:
    """(queries a chunk, ring stages) of the list-major pass 1
    (``nvdb_ivf_probe_list_plan``)."""
    nq, stages = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().nvdb_ivf_probe_list_plan(mode, dp, k, nq_max, ctas, max_stages,
                                             ctypes.byref(nq), ctypes.byref(stages))
    if rc != 0:
        raise RuntimeError(f"ivf_probe_topk: no list-major plan fits shared memory at Dp={dp} "
                           f"k={k}: cudaError_t {rc}")
    return nq.value, stages.value


def list_ranges(B: int, P: int, lcap: int, n_sm: int) -> int:
    """Row ranges R a list's live prefix is cut into: 1 when the batch has
    ``_LIST_CTAS_PER_SM`` pairs a SM or more, else enough that the items of
    distinct lists still make that many CTAs, none shorter than one tile,
    and no more than keep a query's P x R partial lists within
    ``_LIST_MAX_PARTIALS`` (the merge folds them one after another)."""
    want = _LIST_CTAS_PER_SM * n_sm
    if B * P >= want:
        return 1
    return max(1, min(cdiv(want, B * P), cdiv(lcap, _LIST_RANGE_ROWS),
                      _LIST_MAX_PARTIALS // P))


def max_items(pairs: int, nlist: int, nq: int) -> int:
    """The most work items ``pairs`` pairs can make in chunks of ``nq``: an
    item holds one pair at least, and a list's items all but its last hold
    nq."""
    return max(1, min(pairs, pairs // nq + min(nlist, pairs)))


def group_scratch_ints(nlist: int, pairs: int, items: int) -> int:
    """Length of the int32 scratch of pass 0 (``group_pairs.cuh``, shared
    with the fused ADC key scan): counts, order, n_items, then items of 4
    ints from a 16-byte boundary (``items_offset`` in the source)."""
    return round_up(nlist + pairs + 1, 4) + 4 * items


def group_pairs_cuda(probes: torch.Tensor, fills: torch.Tensor, q_chunk: int,
                     lcap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 0 of the list-major kernel alone, for its tests: (order, items)
    as ``group_pairs_reference`` gives them, but for the order of the items
    (the longest lists first) and of each list's pairs (the atomics'). Reads
    the item count back to the host."""
    require_cuda(probes, "ivf group_pairs")
    B, P = probes.shape
    nlist = fills.shape[0]
    dev = probes.device
    probes = probes.to(torch.int32).contiguous()
    check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))
    cap = max_items(B * P, nlist, q_chunk)
    scratch = torch.empty(group_scratch_ints(nlist, B * P, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().nvdb_ivf_group_pairs(probes.data_ptr(), fills.data_ptr(), scratch.data_ptr(),
                                         B, P, nlist, lcap if lcap is not None else 1 << 30,
                                         q_chunk, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ivf group_pairs kernel launch failed: cudaError_t {rc}")
    n_items = int(scratch[nlist + B * P])
    start = round_up(nlist + B * P + 1, 4)
    items = scratch[start:start + 4 * n_items].view(n_items, 4)[:, :3].clone()
    n_valid = int(items[:, 2].sum())
    return scratch[nlist:nlist + n_valid].clone(), items


def ivf_probe_topk_cuda(
    queries: torch.Tensor,              # [B, Dp] f32
    probes: torch.Tensor,               # [B, P] int32 list ids
    packed: torch.Tensor,               # [nlist, Lcap, Dp] f32 | bf16 | int8
    slot_ids: torch.Tensor,             # [nlist, Lcap] int32 (-1 padding)
    slot_scales: Optional[torch.Tensor],  # [nlist, Lcap] f32 (int8 slabs)
    k: int,
    fills: Optional[torch.Tensor] = None,  # [nlist] int32 (list_fills), cached by callers
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over each query's probed list slabs; the contract of
    ``ivf_probe_topk_reference``: pairs grouped by list, each list read once
    a chunk of queries. Returns (vals [B, k] f32, ids [B, k] int32). No host
    sync: the launches can be captured in a CUDA graph."""
    global LAUNCHES
    with trace.span("ivf_probe_topk_cuda") as sp:
        require_cuda(packed, "ivf_probe_topk")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        if packed.dim() != 3 or queries.dim() != 2 or probes.dim() != 2:
            raise ValueError("queries [B, Dp], probes [B, P], packed [nlist, Lcap, Dp]")
        dev = packed.device
        nlist, L, Dp = packed.shape
        B, P = probes.shape
        if Dp % 16 != 0:
            raise ValueError(f"padded dim {Dp} is not a multiple of 16 (16-byte loads)")
        given = probes, fills
        probes = probes.to(torch.int32).contiguous()
        if fills is None:
            fills = list_fills(slot_ids)
        check_tensor(packed, "packed", dev, tuple(_MODES), (nlist, L, Dp))
        check_tensor(queries, "queries", dev, (torch.float32,), (B, Dp))
        check_tensor(probes, "probes", dev, (torch.int32,), (B, P))
        check_tensor(slot_ids, "slot_ids", dev, (torch.int32,), (nlist, L))
        check_tensor(fills, "fills", dev, (torch.int32,), (nlist,))
        if (packed.dtype == torch.int8) != (slot_scales is not None):
            raise ValueError("per-slot scales go with int8 slabs, and only with them")
        if slot_scales is not None:
            check_tensor(slot_scales, "slot_scales", dev, (torch.float32,), (nlist, L))

        vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        if sp:
            sp.count_alloc(vals, ids, None if probes is given[0] else probes,
                           None if fills is given[1] else fills)
        if B == 0 or P == 0:
            vals.fill_(ops.NEG_INF)
            ids.fill_(-1)
            return vals, ids
        mode = _MODES[packed.dtype]
        scales_ptr = slot_scales.data_ptr() if slot_scales is not None else None
        lib = _lib()
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            nq, n_stages = _list_plan(mode, Dp, k, index, _LIST_NQ_MAX, _LIST_PLAN_CTAS,
                                      _LIST_MAX_STAGES)
            R = list_ranges(B, P, L, _sm_count(index))
            U = max_items(B * P, nlist, nq)
            # one int32 allocation: pass 0's scratch, then the partial lists' ids
            head = group_scratch_ints(nlist, B * P, U)
            scratch = torch.empty(head + B * P * R * k, dtype=torch.int32, device=dev)
            part_vals = torch.empty((B, P * R, k), dtype=torch.float32, device=dev)
            if sp:
                sp.count_alloc(scratch, part_vals)
            with trace.span("launch"):
                rc = lib.nvdb_ivf_probe_topk_list(
                    queries.data_ptr(), probes.data_ptr(), packed.data_ptr(),
                    slot_ids.data_ptr(), scales_ptr, fills.data_ptr(), scratch.data_ptr(),
                    part_vals.data_ptr(), scratch.data_ptr() + 4 * head, vals.data_ptr(),
                    ids.data_ptr(), B, P, nlist, L, Dp, k, R, nq, n_stages, U, mode, stream)
        if rc != 0:
            raise RuntimeError(f"ivf_probe_topk kernel launch failed: cudaError_t {rc}")
        LAUNCHES += 1
        return vals, ids
