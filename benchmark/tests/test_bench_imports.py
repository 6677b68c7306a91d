"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hipace_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "hipace_tpu_torch" not in top_level_imports(path), path
        assert not top_level_imports(path) & FORBIDDEN, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run on the CPU in a fresh process, then the run's own
    look at sys.modules."""
    code = (
        "import sys\n"
        "from benchmark import manifest, run\n"
        "from benchmark.tests.conftest import small_config\n"
        "man = manifest.Manifest()\n"
        "cfg = small_config(man.config('transverse_explicit'))\n"
        "run.run_cell(man, 'explicit.2047', 7, 0.0, True, device='cpu',"
        " cfg=cfg)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hipace_tpu_torch_x", sys)
    assert "hipace_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hipace_tpu.ops", sys)
    assert "hipace_tpu" in run.forbidden_modules()
