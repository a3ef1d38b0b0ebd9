"""The corpus generators and the traffic generator repeat by seed."""

import numpy as np
import pytest
import torch

from portbench import queries, spec
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("cell", ["tiny.ivfpq", "tiny.partition"])
def test_corpus_repeats_by_seed_and_is_unit_norm(cell):
    p = tiny_cell(cell).config["corpus"]
    gen = spec.corpus_generator(p["generator"])
    big = 2**31 + 12345
    a = gen.generate(p, torch.Generator().manual_seed(big), "cpu")
    b = gen.generate(p, torch.Generator().manual_seed(big), "cpu")
    c = gen.generate(p, torch.Generator().manual_seed(big + 1), "cpu")
    assert a.shape == (p["n"], p["dim"]) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.allclose(torch.linalg.vector_norm(a, dim=1), torch.ones(p["n"]), atol=1e-5)


def test_hard_corpus_is_low_rank_plus_noise():
    p = tiny_cell("tiny.partition").config["corpus"]
    x = spec.corpus_generator("hard").generate(p, torch.Generator().manual_seed(3), "cpu")
    s = torch.linalg.svdvals(x - x.mean(0))
    # the latent dimensions carry nearly all the variance, the ambient noise the rest
    assert float((s[:p["intrinsic"]] ** 2).sum() / (s ** 2).sum()) > 0.95


def test_pool_and_send_order_repeat_by_seed():
    mix = {"loop": "closed", "clients": 1, "batch": 3, "pool": 10, "perturb": 0.05}
    corpus = torch.nn.functional.normalize(torch.randn(50, 8), dim=1)
    a = queries.make_pool(mix, corpus, torch.Generator().manual_seed(9))
    b = queries.make_pool(mix, corpus, torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and a.shape == (10, 8)
    o = queries.send_order(mix, 2**33 + 1)
    assert np.array_equal(o, queries.send_order(mix, 2**33 + 1))
    assert sorted(o[:10]) == list(range(10)) and np.array_equal(o[10:], o[:3])
    assert not np.array_equal(o, queries.send_order(mix, 2**33 + 2))


def test_only_closed_loop_mixes():
    with pytest.raises(ValueError):
        queries.check_mix({"loop": "open", "batch": 1, "pool": 4})
