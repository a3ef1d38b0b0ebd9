"""Nothing of the benchmark reaches JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the program."""

import ast
import subprocess
import sys

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "nvdb_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "queries.py"):
        tops = {n.split(".")[0] for n in _imports(spec.HERE / name)}
        assert "nvdb_tpu_torch" not in tops and not tops & FORBIDDEN


def test_the_prefix_is_no_match():
    assert run.forbidden_modules.__doc__
    sys.modules.setdefault("nvdb_tpu_torchlike", sys)
    assert "nvdb_tpu_torchlike" not in run.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    code = ("from portbench import run, spec, control\n"
            "from portbench.tests.conftest import tiny_cell\n"
            "for c in ('tiny.ivfpq', 'tiny.partition'):\n"
            "    run.run_cell(tiny_cell(c), 3, 0.1, True, device='cpu')\n"
            "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
