"""The reference's exact top-k, scores and checks against brute force."""

import numpy as np
import pytest
import torch

from portbench import reference


def _state(rows, nlist=8, seed=0):
    """A toy partition of ``rows``: random centroids, each row in its
    nearest list."""
    g = torch.Generator().manual_seed(seed)
    cents = rows[torch.randperm(rows.shape[0], generator=g)[:nlist]].clone()
    lists = torch.argmax(rows @ cents.T * 2 - (cents * cents).sum(1), dim=1)
    lcap = int(torch.bincount(lists).max())
    slot_ids = torch.full((nlist, lcap), -1, dtype=torch.int32)
    for li in range(nlist):
        ids = torch.nonzero(lists == li)[:, 0]
        slot_ids[li, :ids.numel()] = ids.int()
    return reference.IndexState(rotation=None, centroids=cents, slot_ids=slot_ids)


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_exact_topk_matches_numpy(metric):
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((37, 24)).astype(np.float32)
    v, i = reference.exact_topk(torch.from_numpy(corpus), torch.from_numpy(q), 10, metric,
                                q_block=16, n_block=128)
    s = q.astype(np.float64) @ corpus.T.astype(np.float64)
    if metric == "l2":
        s = 2 * s - (corpus.astype(np.float64) ** 2).sum(1)[None]
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    assert np.array_equal(i.numpy(), want)
    assert np.allclose(v.numpy(), np.take_along_axis(s, want, 1))


def test_judge_passes_exact_answers_and_catches_faults():
    rows = torch.nn.functional.normalize(torch.randn(400, 16, generator=torch.Generator().manual_seed(1)), dim=1)
    st = _state(rows)
    q = rows[:20] + 0.01
    search = {"k": 5, "nprobe": 8, "metric": "dot", "candidate_score": "bf16",
              "rerank_k": 20}   # every list probed
    v, i = reference.exact_topk(rows, q, 5, "dot")
    ok = reference.judge(q, v.float(), i, rows, st, search)
    assert ok["bad_results"] == 0 and ok["off_probe"] == 0 and ok["score_err"] < 1e-6
    wrong = i.clone()
    wrong[0, 0] = (wrong[0, 0] + 1) % 400
    assert reference.judge(q, v.float(), wrong, rows, st, search)["score_err"] > 1e-4
    dup = i.clone()
    dup[1, 1] = dup[1, 0]
    assert reference.judge(q, v.float(), dup, rows, st, search)["bad_results"] == 1
    miss = i.clone()
    miss[2, 4] = -1
    assert reference.judge(q, v.float(), miss, rows, st, search)["bad_results"] == 1
    one = dict(search, nprobe=1)
    far = reference.judge(q, v.float(), i, rows, st, one)
    assert far["off_probe"] > 0 and far["failed_rows"] > 0
    assert ok["missed"] == 0
    # exact scores of other rows of the probed lists: only ``missed`` sees it
    worse_v, worse_i = reference.exact_topk(rows, q, 10, "dot")
    low = reference.judge(q, worse_v[:, 5:].float(), worse_i[:, 5:], rows, st, search)
    assert low["score_err"] < 1e-6 and low["off_probe"] == 0 and low["bad_results"] == 0
    assert low["missed"] == 5 * q.shape[0] and low["failed_rows"] == q.shape[0]


def test_must_return_allows_the_rounding_band():
    cv = torch.tensor([[5.0, 4.0, 3.0, 2.95, 1.0, 0.0]], dtype=torch.float64)
    band = torch.full_like(cv, 0.1)
    # best 3 of 6: ranks 3 and 4 lie within their bands of each other
    assert reference.must_return(cv, band, 3).tolist() == [[True, True, False, False,
                                                           False, False]]
    # the last kept row could still outrank the first when the bands are wide
    assert not reference.must_return(cv, torch.full_like(cv, 3.0), 3).any()


def test_pq_reconstruction_scores_as_the_adc_tables_do():
    g = torch.Generator().manual_seed(4)
    m, dsub, nlist = 4, 2, 3
    cents = torch.randn(nlist, m * dsub, generator=g)
    cb = torch.randn(m, 256, dsub, generator=g)
    codes = torch.randint(0, 256, (nlist, m, 5), generator=g, dtype=torch.uint8)
    slot_ids = torch.arange(nlist * 5, dtype=torch.int32).reshape(nlist, 5)
    st = reference.IndexState(rotation=None, centroids=cents, slot_ids=slot_ids,
                              codes=codes, codebooks=cb)
    rec = reference.pq_reconstruction(st, nlist * 5).double()
    q = torch.randn(m * dsub, generator=g, dtype=torch.float64)
    for li in range(nlist):
        res = (q - cents[li].double()).reshape(m, dsub)
        for s in range(5):
            adc = sum(float(((res[j] - cb[j, codes[li, j, s].long()].double()) ** 2).sum())
                      for j in range(m))
            assert float(((q - rec[slot_ids[li, s]]) ** 2).sum()) == pytest.approx(adc)


def test_start_checks_find_a_row_held_twice_or_lost():
    rows = torch.nn.functional.normalize(torch.randn(300, 16, generator=torch.Generator().manual_seed(2)), dim=1)
    st = _state(rows)
    assert reference.start_checks(rows, st)["unplaced_rows"] == 0
    live = torch.nonzero(st.slot_ids[0] >= 0)[:, 0]
    st.slot_ids[0, live[0]] = st.slot_ids[0, live[1]]
    assert reference.start_checks(rows, st)["unplaced_rows"] == 2   # one lost, one twice


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert torch.equal(reference.tf32_round(x),
                       torch.tensor([1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]))


def test_recall_counts_the_true_ids():
    ids = torch.tensor([[1, 2, 3], [7, 8, 9]])
    truth = torch.tensor([[3, 2, 5], [1, 2, 4]])
    assert reference.recall_at(ids, truth, 3).tolist() == pytest.approx([2 / 3, 0.0])
