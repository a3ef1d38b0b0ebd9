"""The list-major IVF probe kernel's host-side pieces, on the CPU: the
plain version of its grouping pass (``group_pairs_reference``), the grid
bound and row ranges the wrapper sizes pass 1 with, and ``probe_bytes``,
the bytes a probe batch moves counted as probed and distinct. The CUDA
pass itself is held to ``group_pairs_reference`` in
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.kernels import ivf_scan

# nlist 6: lists 0 and 3 dead (fill 0), list 1 probed twice by query 0
FILLS = torch.tensor([0, 5, 3, 0, 7, 2], dtype=torch.int32)
PROBES = torch.tensor([[1, 1, 2, -1],
                       [4, 1, 9, 3],
                       [5, 0, 4, 2]], dtype=torch.int32)


def test_group_pairs_reference_order_and_items():
    order, items = ivf_scan.group_pairs_reference(PROBES, FILLS, q_chunk=2)
    # valid pairs b * P + p by list, ascending within a list: list 1 <- 0, 1,
    # 5; list 2 <- 2, 11; list 4 <- 4, 10; list 5 <- 8. Dropped: -1, 9 (out of
    # range) and the dead lists 3 and 0.
    assert order.tolist() == [0, 1, 5, 2, 11, 4, 10, 8]
    assert items.tolist() == [[1, 0, 2], [1, 2, 1], [2, 3, 2], [4, 5, 2], [5, 7, 1]]
    assert order.dtype == items.dtype == torch.int32


@pytest.mark.parametrize("seed,b,p,nlist,q", [(0, 1, 1, 4, 32), (1, 8, 7, 30, 2),
                                              (2, 64, 32, 50, 8), (3, 256, 16, 9, 32)])
def test_group_pairs_reference_covers_each_valid_pair_once(seed, b, p, nlist, q):
    rng = np.random.default_rng(seed)
    probes = torch.from_numpy(rng.integers(-2, nlist + 2, (b, p)).astype(np.int32))
    fills = torch.from_numpy(rng.integers(0, 4, nlist).astype(np.int32))
    order, items = ivf_scan.group_pairs_reference(probes, fills, q)
    flat = probes.reshape(-1).long()
    valid = [j for j, l in enumerate(flat.tolist()) if 0 <= l < nlist and fills[l] > 0]
    assert sorted(order.tolist()) == valid
    pos = 0
    for lst, start, cnt in items.tolist():
        assert start == pos and 1 <= cnt <= q
        seg = order[start:start + cnt].tolist()
        assert all(flat[j] == lst for j in seg) and seg == sorted(seg)
        pos += cnt
    assert pos == order.numel()
    assert items.shape[0] <= ivf_scan.max_items(b * p, nlist, q)   # the grid covers them


def test_grid_bound_is_tight_where_one_list_takes_every_pair():
    """Every pair on one list: ceil(BP / q) items; every pair on its own
    list: BP items. max_items covers both."""
    probes = torch.zeros((256, 1), dtype=torch.int32)
    _, items = ivf_scan.group_pairs_reference(probes, torch.tensor([5], dtype=torch.int32), 32)
    assert items.shape[0] == 8 <= ivf_scan.max_items(256, 1, 32)
    probes = torch.arange(256, dtype=torch.int32)[:, None]
    _, items = ivf_scan.group_pairs_reference(probes, torch.ones(256, dtype=torch.int32), 32)
    assert items.shape[0] == 256 == ivf_scan.max_items(256, 256, 32)


@pytest.mark.parametrize("b,p,lcap,want", [
    (256, 64, 384, 1),     # IVF-Flat's batch: enough pairs
    (64, 32, 992, 1),      # the partition batch
    (8, 64, 384, 1),
    (1, 32, 992, 2),       # 64 partials a query at most
    (1, 1, 992, 16),       # one list in tiles of 64 rows
    (8, 7, 992, 5),
])
def test_list_ranges(b, p, lcap, want):
    assert ivf_scan.list_ranges(b, p, lcap, n_sm=132) == want


def test_probe_bytes_as_probed_and_distinct():
    row_bytes, dp, k = 16, 8, 3
    got = ivf_scan.probe_bytes(PROBES, FILLS, row_bytes, nlist=6, dp=dp, k=k)
    # as probed: query 0 lists 1, 1, 2; query 1 lists 4, 1; query 2 lists 5, 4, 2
    assert got["as_probed"] == (5 + 5 + 3 + 7 + 5 + 2 + 7 + 3) * row_bytes
    rows = 5 + 3 + 7 + 2   # lists 1, 2, 4, 5 once
    assert got["rows"] == rows and got["lists"] == 4 and got["pairs"] == 8
    assert got["distinct"] == rows * (row_bytes + 4) + 3 * dp * 4 + PROBES.numel() * 4 + 3 * k * 8


def test_probe_bytes_brute_force():
    rng = np.random.default_rng(7)
    nlist = 40
    probes = torch.from_numpy(rng.integers(-3, nlist + 3, (33, 11)).astype(np.int32))
    fills = torch.from_numpy(rng.integers(0, 30, nlist).astype(np.int32))
    got = ivf_scan.probe_bytes(probes, fills, 100, nlist)
    pairs = [l for l in probes.reshape(-1).tolist() if 0 <= l < nlist and fills[l] > 0]
    assert got["as_probed"] == sum(int(fills[l]) for l in pairs) * 100
    assert got["rows"] == sum(int(fills[l]) for l in set(pairs))
    assert got["distinct"] == got["rows"] * 104 + probes.numel() * 4
    assert got["distinct"] < got["as_probed"]   # 33 queries share 40 lists
