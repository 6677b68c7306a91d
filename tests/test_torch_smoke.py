"""``chip_smoke.py`` and the deck it runs, checked without a GPU.

The smoke run drives the port alone: it imports nothing of JAX or of the
JAX package, runs the port's copy of the flagship deck, and without a
usable GPU, or away from the repository, exits non-zero with no result.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import __graft_entry__
from hipace_tpu_torch.decks import BLOWOUT_WAKE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def test_port_deck_is_the_flagship_deck():
    assert BLOWOUT_WAKE == __graft_entry__._DECK


def test_smoke_imports_only_the_port():
    tree = ast.parse(open(SMOKE).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "hipace_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "hipace_tpu", "__graft_entry__"}, \
        tops


@pytest.mark.parametrize("where", ["repository", "alone"])
def test_smoke_fails_without_gpu_or_repository(tmp_path, where):
    """Here there is no CUDA device; alone there is no repository either.
    Both runs exit non-zero and print no result line."""
    script = SMOKE
    if where == "repository" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would pass")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line
