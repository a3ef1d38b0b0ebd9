"""The plain reference that decides ``correct``, and the control.

Plain PyTorch in float64 on the benchmark's own copy of the corpus and the
queries (made again from the seed after the window). It imports nothing of
the program. What it cannot work out again, the trained quantizer and the
PQ codes, it reads from the index the program built (``IndexState``) and
checks by itself: every row held once, every PQ code a nearest codeword of
its row's residual, a sample of the packed bf16 payload the rows rounded.

Numbers compared (each beside its limit in the configuration's
``limits``):

- ``bad_results``: answers whose ids are out of range, repeated, or whose
  scores are not finite or not in descending order. Exact, limit 0.
- ``score_err``: the widest gap between a returned score and the float64
  score of the returned id under the configuration's metric.
- ``off_probe``: returned ids held in no list that the float64 coarse
  ranking puts among the query's top ``nprobe`` (within ``COARSE_MARGIN``
  of the ``nprobe``-th list's score). Exact, limit 0.
- ``missed``: rows that the configuration's search must return and the
  answer lacks. A row must be returned where it lies in a list surely
  among the top ``nprobe``, its candidate score (``candidate_score``: the
  PQ reconstruction's L2, or the bf16 rows' dot product) is surely among
  the best ``refine_k`` / ``rerank_k`` of every row of the lists that may
  be probed, allowing each score its rounding band, and its exact score
  beats the answer's k-th by more than ``REFINE_MARGIN``. Exact, limit 0.
- ``unplaced_rows``, ``payload_mismatch``, ``code_mismatch``: the start
  checks of the index state. Exact, limit 0.

The control (``control_search``) is the reference put in the program's
place: the float64 coarse ranking's probes, then every probed row scored
exactly, top-k; all of it in TF32 (inputs rounded to 10 mantissa bits,
f32 accumulation), the nearest precision below the f32 the configurations
state (the program runs its f32 products with TF32 off)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

F64 = torch.float64
# The coarse ranking's rounding allowance: the worst-case f32 error of
# 2 q.c - ||c||^2 over 768 dims with |q| = 1 and |c| <= 1 is ~1.5e-4
# (rotation included ~3e-4); three times that.
COARSE_MARGIN = 1e-3
# The PQ encode's allowance: its f32 argmin of ||c||^2 - 2 r.c over 8- to
# 12-dim subspaces of residuals of norm < 1 errs by < 1e-6.
CODE_MARGIN = 1e-5
START_SAMPLE = 4096
# The candidate stage's rounding bands: a row nearer the cut than its band
# may fall either side of it.
# pq: each ADC table entry rounded to bf16 (half an ulp, at most 2^-8 of the
# entry; a row's entries sum to its ADC distance D), the sum truncated to
# bf16 for the key (under one ulp, at most 2^-7 of D), and f32 cancellation
# in the entries ||r||^2 - 2 r.c + ||c||^2 (PQ_ABS). Linear in D, so a
# row's score plus its band falls as the score does.
PQ_REL = 3 * 2.0 ** -8
PQ_ABS = 1e-5
# bf16: the f32 accumulation of the exact bf16 products of a 768-dim dot
# product, under 768 * 2^-24 ||q|| ||r|| = 4.6e-5 ||q|| ||r||; twice that.
BF16_REL = 1e-4
# The exact refine's f32 error: twice the score_err limit.
REFINE_MARGIN = 2e-5
# rows of the candidate scan a block, and the best rows each query keeps
CAND_BLOCK = 65_536
CAND_KEEP = 4


@dataclasses.dataclass
class IndexState:
    """What the reference reads of the program's index: the quantizer it
    cannot train again, and a sample of the payload to check the packing."""
    rotation: Optional[torch.Tensor]   # [Dp, Dp] f32 (IVF-OPQ-PQ) or None
    centroids: torch.Tensor            # [nlist, Dp] f32 (rotated space)
    slot_ids: torch.Tensor             # [nlist, Lcap] int32, -1 empty
    replicas: int = 1
    sample_slots: Optional[torch.Tensor] = None   # [S, 2] (list, slot) of live slots
    sample_payload: Optional[torch.Tensor] = None  # [S, Dp] bf16 rows (partition)
    codes: Optional[torch.Tensor] = None           # [nlist, M, Lcap] uint8 (IVF-PQ)
    codebooks: Optional[torch.Tensor] = None       # [M, 256, dsub] f32


def sample_live_slots(slot_ids: torch.Tensor, seed: int, count: int = START_SAMPLE
                      ) -> torch.Tensor:
    """[S, 2] (list, slot) of live slots, drawn from the seed."""
    li, si = torch.nonzero(slot_ids >= 0, as_tuple=True)
    rng = np.random.default_rng([seed & (2**63 - 1), 2])
    pick = torch.from_numpy(rng.choice(li.numel(), size=min(count, li.numel()),
                                       replace=False)).to(li.device)
    return torch.stack([li[pick], si[pick]], dim=1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def metric_scores(dots: torch.Tensor, norms2: torch.Tensor, metric: str) -> torch.Tensor:
    """The configuration's score from dot products: ``dot`` or ``l2``
    (2 q.r - ||r||^2, which ranks as the L2 distance does)."""
    if metric == "dot":
        return dots
    if metric == "l2":
        return 2.0 * dots - norms2
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int, metric: str,
               q_block: int = 1024, n_block: int = 262_144):
    """The exact top-k of every query over every corpus row, in float64:
    (scores [Q, k] f64, ids [Q, k] int64)."""
    vals, ids = [], []
    for qs in range(0, queries.shape[0], q_block):
        q = queries[qs:qs + q_block].to(F64)
        best_v = torch.full((q.shape[0], k), -torch.inf, dtype=F64, device=q.device)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
        for ns in range(0, corpus.shape[0], n_block):
            r = corpus[ns:ns + n_block].to(F64)
            s = metric_scores(q @ r.T, (r * r).sum(1)[None, :], metric)
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            best_v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, i + ns], 1), 1, pos)
        vals.append(best_v)
        ids.append(best_i)
    return torch.cat(vals), torch.cat(ids)


def rotated(queries: torch.Tensor, state: IndexState) -> torch.Tensor:
    """The queries in the index's space, float64: padded to its width and
    rotated where it rotates them."""
    q = queries.to(F64)
    dp = state.centroids.shape[1]
    if q.shape[1] < dp:
        q = torch.nn.functional.pad(q, (0, dp - q.shape[1]))
    return q @ state.rotation.to(F64) if state.rotation is not None else q


def coarse_scores(queries: torch.Tensor, state: IndexState, tf32: bool = False
                  ) -> torch.Tensor:
    """[Q, nlist] the coarse ranking's 2 q.c - ||c||^2 (queries rotated
    first where the index rotates them), lists with no live slot at -inf;
    float64, or TF32 for the control."""
    c = state.centroids
    live = (state.slot_ids >= 0).any(dim=1)
    if tf32:
        q = tf32_round(queries)
        if state.rotation is not None:
            q = tf32_round(q @ tf32_round(state.rotation))
        s = 2.0 * (q @ tf32_round(c).T) - (c * c).sum(1)[None, :]
    else:
        q = rotated(queries, state)
        c = c.to(F64)
        s = 2.0 * (q @ c.T) - (c * c).sum(1)[None, :]
    return torch.where(live[None, :], s, torch.tensor(-torch.inf, dtype=s.dtype,
                                                      device=s.device))


def list_of_rows(state: IndexState, n: int) -> torch.Tensor:
    """[n] the list each row is held in (replicas 1; -1 where none)."""
    li, si = torch.nonzero(state.slot_ids >= 0, as_tuple=True)
    out = torch.full((n,), -1, dtype=torch.int64, device=li.device)
    out[state.slot_ids[li, si].long()] = li
    return out


def pq_reconstruction(state: IndexState, n: int) -> torch.Tensor:
    """[n, Dp] f32 each row as its PQ code gives it back, in the rotated
    space: its list's centroid plus the codewords of its code."""
    li, si = torch.nonzero(state.slot_ids >= 0, as_tuple=True)
    cb = state.codebooks                                               # [M, 256, dsub]
    m = cb.shape[0]
    out = torch.zeros((n, state.centroids.shape[1]), dtype=torch.float32, device=li.device)
    for s in range(0, li.numel(), CAND_BLOCK):
        l, t = li[s:s + CAND_BLOCK], si[s:s + CAND_BLOCK]
        code = state.codes[l, :, t].long()                             # [b, M]
        words = cb[torch.arange(m, device=code.device)[None, :], code]  # [b, M, dsub]
        rec = state.centroids[l].clone()
        rec[:, :words.shape[1] * words.shape[2]] += words.reshape(l.numel(), -1)
        out[state.slot_ids[l, t].long()] = rec
    return out


def candidate_rows(corpus: torch.Tensor, state: IndexState, kind: str) -> torch.Tensor:
    """[n, D] f32 the rows the candidate stage scores: ``pq`` the PQ
    reconstruction (rotated space), ``bf16`` the rows rounded to bf16."""
    if kind == "pq":
        return pq_reconstruction(state, corpus.shape[0])
    if kind == "bf16":
        return corpus.to(torch.bfloat16).float()
    raise ValueError(f"unknown candidate_score {kind!r}")


def candidate_top(cq: torch.Tensor, rows: torch.Tensor, list_of: torch.Tensor,
                  possible: torch.Tensor, kind: str, keep: int, q_block: int = 1024):
    """The ``keep`` best candidate scores of each query (float64 [Q, keep],
    descending; row ids [Q, keep]) over the rows of its ``possible`` lists:
    ``pq`` -||cq - row||^2 (the ADC distance), ``bf16`` cq . row."""
    Q = cq.shape[0]
    best_v = torch.full((Q, keep), -torch.inf, dtype=F64, device=cq.device)
    best_i = torch.full((Q, keep), -1, dtype=torch.int64, device=cq.device)
    q2 = (cq * cq).sum(1, keepdim=True)
    for ns in range(0, rows.shape[0], CAND_BLOCK):
        r = rows[ns:ns + CAND_BLOCK].to(F64)
        lst = list_of[ns:ns + CAND_BLOCK]
        r2 = (r * r).sum(1)[None, :]
        for qs in range(0, Q, q_block):
            s = cq[qs:qs + q_block] @ r.T
            if kind == "pq":
                s = 2.0 * s - r2 - q2[qs:qs + q_block]
            ok = torch.gather(possible[qs:qs + q_block], 1,
                              torch.clamp(lst, min=0)[None, :].expand(s.shape[0], -1))
            s = torch.where(ok & (lst >= 0)[None, :], s, -torch.inf)
            v, i = torch.topk(s, min(keep, s.shape[1]), dim=1)
            v, pos = torch.topk(torch.cat([best_v[qs:qs + q_block], v], 1), keep, dim=1)
            best_i[qs:qs + q_block] = torch.gather(
                torch.cat([best_i[qs:qs + q_block], i + ns], 1), 1, pos)
            best_v[qs:qs + q_block] = v
    return best_v, best_i


def candidate_band(v: torch.Tensor, cq: torch.Tensor, r_max: float, kind: str
                   ) -> torch.Tensor:
    """[Q, keep] the rounding band of each kept candidate score; ``r_max``
    the largest norm of a candidate row."""
    if kind == "pq":
        return PQ_REL * torch.clamp(-v, min=0.0) + PQ_ABS
    return (BF16_REL * r_max * torch.linalg.vector_norm(cq, dim=1, keepdim=True)).expand_as(v)


def must_return(cv: torch.Tensor, band: torch.Tensor, count: int) -> torch.Tensor:
    """[Q, keep] bool: the kept candidates surely among the best ``count``:
    fewer than ``count`` others can score above them, each score moved by
    its band, and no row past those kept can (the bands shrink as the
    scores fall, so the last kept row bounds every one beyond it)."""
    hi, lo = cv + band, cv - band
    above = (hi[:, None, :] >= lo[:, :, None]).sum(2) - 1               # [Q, keep] others
    tail_ok = (hi[:, -1:] < lo) | torch.isinf(cv[:, -1:])
    pos = torch.arange(cv.shape[1], device=cv.device)[None, :]
    return (pos < count) & (above < count) & tail_ok & torch.isfinite(cv)


def judge(queries: torch.Tensor, vals: torch.Tensor, ids: torch.Tensor,
          corpus: torch.Tensor, state: IndexState, search: dict,
          q_block: int = 1024, rows: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The per-answer numbers of ``vals``/``ids`` ([Q, k], the answers to
    ``queries``): ``bad_results``, ``score_err``, ``off_probe``,
    ``missed``, and ``failed_rows`` (answers with a bad, off-probe or
    missing result). ``rows``: ``candidate_rows``, where already made."""
    n, k, metric = corpus.shape[0], int(search["k"]), search["metric"]
    nprobe = int(search["nprobe"])
    kind = search["candidate_score"]
    count = int(search.get("refine_k", search.get("rerank_k", k)))
    list_of = list_of_rows(state, n)
    if rows is None:
        rows = candidate_rows(corpus, state, kind)
    r_max = float(torch.linalg.vector_norm(rows, dim=1).max())
    bad = off = missed = failed = 0
    err = 0.0
    for s in range(0, queries.shape[0], q_block):
        v = vals[s:s + q_block].to(queries.device)
        i = ids[s:s + q_block].to(queries.device).long()
        q = queries[s:s + q_block]
        valid = (i >= 0) & (i < n)
        srt = torch.sort(i, dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        order = (v[:, 1:] > v[:, :-1]).any(1)
        row_bad = (~valid).any(1) | dup | order | (~torch.isfinite(v)).any(1)
        if i.shape[1] != k:
            row_bad[:] = True
        bad += int(row_bad.sum())
        safe = torch.where(valid, i, 0)
        got = corpus[safe].to(F64)                                     # [b, k, d]
        exact = metric_scores(torch.einsum("bd,bkd->bk", q.to(F64), got),
                              (got * got).sum(2), metric)
        gap = torch.where(valid, (v.to(F64) - exact).abs(), torch.zeros_like(exact))
        err = max(err, float(gap.max()))
        cs = coarse_scores(q, state)
        top = torch.topk(cs, min(nprobe + 1, cs.shape[1]), dim=1).values
        thr = top[:, nprobe - 1:nprobe]
        lst = list_of[safe]
        held = torch.gather(cs, 1, torch.clamp(lst, min=0))
        out = valid & ((lst < 0) | (held < thr - COARSE_MARGIN))
        off += int(out.sum())
        # the rows the search must return: candidates of surely probed lists
        possible = cs >= thr - COARSE_MARGIN
        sure_list = (cs > top[:, -1:] + COARSE_MARGIN) if top.shape[1] > nprobe else possible
        cq = rotated(q, state) if kind == "pq" else q.to(torch.bfloat16).to(F64)
        cv, ci = candidate_top(cq, rows, list_of, possible, kind, CAND_KEEP * count)
        must = must_return(cv, candidate_band(cv, cq, r_max, kind), count)
        must &= torch.gather(sure_list, 1, torch.clamp(list_of[torch.clamp(ci, min=0)], min=0))
        cand = corpus[torch.clamp(ci[:, :count], min=0)].to(F64)      # [b, count, d]
        c_exact = metric_scores(torch.einsum("bd,bcd->bc", q.to(F64), cand),
                                (cand * cand).sum(2), metric)
        kth = torch.where(valid, exact, torch.inf).min(1, keepdim=True).values
        held_back = (ci[:, :count, None] == i[:, None, :]).any(2)
        lack = must[:, :count] & (c_exact > kth + REFINE_MARGIN) & ~held_back
        missed += int(lack.sum())
        failed += int((row_bad | out.any(1) | lack.any(1)).sum())
    return {"bad_results": float(bad), "score_err": err, "off_probe": float(off),
            "missed": float(missed), "failed_rows": float(failed)}


def start_checks(corpus: torch.Tensor, state: IndexState) -> Dict[str, float]:
    """The index state against the corpus: ``unplaced_rows`` (rows not held
    exactly ``replicas`` times); ``code_mismatch`` (IVF-PQ: every live
    slot's code, each sub-code a nearest codeword of the rotated residual
    within ``CODE_MARGIN``); ``payload_mismatch`` (partition: on the sampled
    slots, a bf16 row not the row rounded to bf16, or padding not 0)."""
    n = corpus.shape[0]
    held = state.slot_ids[state.slot_ids >= 0].long()
    counts = torch.bincount(held, minlength=n)
    out = {"unplaced_rows": float(int((counts[:n] != state.replicas).sum())
                                  + int((held >= n).sum()))}
    if state.sample_payload is not None:
        li, si = state.sample_slots[:, 0], state.sample_slots[:, 1]
        rows = corpus[state.slot_ids[li, si].long()]
        d = rows.shape[1]
        got = state.sample_payload[:, :d].contiguous().view(torch.int16)
        want = rows.to(torch.bfloat16).view(torch.int16)
        pad = state.sample_payload[:, d:]
        out["payload_mismatch"] = float(int((got != want).any(1).sum())
                                        + int((pad != 0).any(1).sum()))
    if state.codes is not None:
        cb = state.codebooks.to(F64)                                   # [M, 256, dsub]
        m, _, dsub = cb.shape
        c2 = (cb * cb).sum(2)[None]
        li, si = torch.nonzero(state.slot_ids >= 0, as_tuple=True)
        worse = 0
        for s in range(0, li.numel(), CAND_BLOCK // 4):
            l, t = li[s:s + CAND_BLOCK // 4], si[s:s + CAND_BLOCK // 4]
            r = rotated(corpus[state.slot_ids[l, t].long()], state)
            res = (r - state.centroids[l].to(F64))[:, :m * dsub].reshape(-1, m, dsub)
            val = c2 - 2.0 * torch.einsum("smd,mcd->smc", res, cb)
            got = torch.gather(val, 2, state.codes[l, :, t].long()[:, :, None])[:, :, 0]
            worse += int((got > val.min(2).values + CODE_MARGIN).any(1).sum())
        out["code_mismatch"] = float(worse)
    return out


def control_search(queries: torch.Tensor, corpus: torch.Tensor, state: IndexState,
                   search: dict, q_block: int = 16):
    """The reference in the program's place, in TF32: the coarse ranking's
    top ``nprobe`` lists, every row they hold scored exactly, the top k.
    Returns (scores [Q, k] f32, ids [Q, k] int64)."""
    k, nprobe, metric = int(search["k"]), int(search["nprobe"]), search["metric"]
    vals, ids = [], []
    for s in range(0, queries.shape[0], q_block):
        q = queries[s:s + q_block]
        probes = torch.topk(coarse_scores(q, state, tf32=True), nprobe, dim=1).indices
        cand = state.slot_ids[probes].reshape(q.shape[0], -1).long()   # [b, P * Lcap]
        rows = tf32_round(corpus[torch.clamp(cand, min=0)])           # [b, C, d]
        dots = torch.einsum("bd,bcd->bc", tf32_round(q), rows)
        sc = metric_scores(dots, (rows * rows).sum(2), metric)
        sc = torch.where(cand >= 0, sc, torch.tensor(-torch.inf, device=sc.device))
        v, pos = torch.topk(sc, k, dim=1)
        vals.append(v.float())
        ids.append(torch.gather(cand, 1, pos))
    return torch.cat(vals), torch.cat(ids)


def recall_at(ids: torch.Tensor, truth: torch.Tensor, k: int) -> torch.Tensor:
    """[Q] the share of each query's true top-k among its first k ids."""
    hit = (ids[:, :k, None].long() == truth[:, None, :k]).any(2)
    return hit.float().sum(1) / k
