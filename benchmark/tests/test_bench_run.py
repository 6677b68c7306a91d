"""The command fails without a card, and without the program."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "explicit.2047", "--seed", "12", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone: the
    harness runs the cell on the CPU as far as it can, and fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from benchmark import manifest, run\n"
            "from benchmark.tests.conftest import small_config\n"
            "man = manifest.Manifest()\n"
            "run.run_cell(man, 'explicit.2047', 1, 0.0, False, device='cpu', "
            "cfg=small_config(man.config('transverse_explicit')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "hipace_tpu_torch" in out.stderr
    assert _run(tmp_path).returncode != 0
