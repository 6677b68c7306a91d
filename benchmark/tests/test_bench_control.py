"""On the card, at each cell's own size: the program as configured
(float64) reads correct = true, and the control, the program in float32,
the nearest precision below, reads correct = false; a cell on four cards
skips on fewer. Run on the card with
``python3 -m pytest benchmark/tests -m gpu``; skips where there is no
card."""

import pytest
import torch

from benchmark import run

CELLS = ("explicit.2047",)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(man, card, cell):
    chips = man.cell(cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    seed = 2**31 + 2024
    line, lines = run.run_cell(man, cell, seed, 0.0, False, device=card)
    assert line["correct"], lines
    torch.cuda.empty_cache()
    line, lines = run.run_cell(man, cell, seed, 0.0, False, device=card,
                               dtype=torch.float32)
    assert not line["correct"], lines
