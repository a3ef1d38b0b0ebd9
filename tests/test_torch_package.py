"""The port's package-level names and dispatch switches against the JAX
package's: every public name of each ``nvdb_tpu`` package ``__init__`` has
a counterpart in ``nvdb_tpu_torch``'s (read from the JAX source with
``ast``, so nothing of JAX is imported), and ``NVDB_REFINE_BACKEND`` forces
the refine alone, as ``nvdb_tpu.kernels.dispatch.refine_backend`` lets it."""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from nvdb_tpu_torch.kernels import dispatch, rerank

ROOT = pathlib.Path(__file__).resolve().parents[1]
# JAX names with no torch meaning: a JAX platform pick and jax.sharding helpers
NO_COUNTERPART = {"default_backend", "row_sharding", "replicated"}


def _public_names(path: pathlib.Path) -> set:
    """Names a module binds at its top level (imports, defs, assignments),
    but those starting with an underscore."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


JAX_INITS = sorted((ROOT / "nvdb_tpu").rglob("__init__.py"))


@pytest.mark.parametrize("init", JAX_INITS, ids=lambda p: str(p.parent.relative_to(ROOT)))
def test_package_names_match_jax(init):
    rel = init.parent.relative_to(ROOT / "nvdb_tpu")
    module = ".".join(("nvdb_tpu_torch",) + rel.parts)
    ported = importlib.import_module(module)
    missing = sorted(n for n in _public_names(init) - NO_COUNTERPART
                     if not hasattr(ported, n))
    assert not missing, f"{module} lacks {missing}"


def test_top_level_index_classes():
    from nvdb_tpu_torch import IVFFlatIndex, IVFPQIndex, PartitionRerankIndex
    from nvdb_tpu_torch.kernels import exact_rerank
    from nvdb_tpu_torch.index import ivf_flat, ivf_pq, partition
    from nvdb_tpu_torch.kernels import ops

    assert (IVFFlatIndex, IVFPQIndex, PartitionRerankIndex) == (
        ivf_flat.IVFFlatIndex, ivf_pq.IVFPQIndex, partition.PartitionRerankIndex)
    assert exact_rerank is ops.exact_rerank


def _refine_case():
    rng = np.random.default_rng(5)
    vectors = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(0, 40, (3, 12)).astype(np.int32))
    return queries, cand, vectors


def _record_paths(monkeypatch):
    """Stand-ins for the three refine paths that record which one ran."""
    calls = []

    def stand_in(name):
        def run(queries, cand_ids, *a, **kw):
            calls.append(name)
            return torch.zeros((queries.shape[0], 2)), torch.zeros((queries.shape[0], 2),
                                                                    dtype=torch.int32)
        return run

    monkeypatch.setattr(rerank, "rerank_topk_cuda", stand_in("cuda"))
    monkeypatch.setattr(rerank, "rerank_topk_reference", stand_in("torch"))
    monkeypatch.setattr(dispatch, "oracle_refine", stand_in("oracle"))
    return calls


@pytest.mark.parametrize("env,force,backend,want", [
    ("pallas", "0", "auto", "cuda"),   # forced onto the kernel, though the tensor is on the CPU
    ("jnp", "0", "auto", "oracle"),
    ("jnp", "1", "auto", "oracle"),    # before NVDB_FORCE_TORCH, as before NVDB_FORCE_JNP in JAX
    ("", "1", "auto", "torch"),        # unset: as before
    ("", "0", "auto", "oracle"),
    ("other", "0", "auto", "oracle"),  # unknown values are ignored, as in the JAX package
    ("pallas", "0", "torch", "torch"),  # an explicit backend wins
    ("jnp", "0", "cuda", "cuda"),
])
def test_refine_backend_env_forces_the_refine(monkeypatch, env, force, backend, want):
    monkeypatch.setenv("NVDB_REFINE_BACKEND", env)
    monkeypatch.setenv("NVDB_FORCE_TORCH", force)
    calls = _record_paths(monkeypatch)
    q, cand, vectors = _refine_case()
    dispatch.exact_refine(q, cand, vectors, None, 2, backend=backend)
    assert calls == [want]


def test_refine_backend_env_leaves_the_scan_alone(monkeypatch):
    """``NVDB_REFINE_BACKEND=pallas`` on CPU tensors: the scan keeps its
    plain path, and the real refine kernel, forced, refuses a CPU tensor."""
    monkeypatch.setenv("NVDB_REFINE_BACKEND", "pallas")
    q, cand, vectors = _refine_case()
    v, i = dispatch.flat_topk(q, vectors, None, 40, 5)
    want = torch.topk(q @ vectors.T, 5, dim=1)
    torch.testing.assert_close(v, want.values)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.exact_refine(q, cand, vectors, None, 2)
    monkeypatch.setenv("NVDB_REFINE_BACKEND", "jnp")
    got = dispatch.exact_refine(q, cand, vectors, None, 2)
    monkeypatch.delenv("NVDB_REFINE_BACKEND")
    ref = dispatch.exact_refine(q, cand, vectors, None, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
