"""The port stands on its own: no import of the JAX package, its own deck
parser, geometry, constants and atomic data held equal to the originals,
the card as the default device, and the host-side layout of the K1 and K3
launches.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from hipace_tpu import constants as jconstants
from hipace_tpu.geometry import Geometry as JGeometry
from hipace_tpu.parser import Inputs as JInputs
from hipace_tpu.utils.atomic_data import ATOMIC_WEIGHTS_DA as JWEIGHTS
from hipace_tpu.utils.atomic_data import IONIZATION_ENERGIES_EV as JENERGIES
from hipace_tpu_torch import constants as tconstants
from hipace_tpu_torch.fields.multigrid import MultiGrid
from hipace_tpu_torch.geometry import Geometry
from hipace_tpu_torch.ops import deposit as tdeposit
from hipace_tpu_torch.ops import mg_kernel
from hipace_tpu_torch.parser import Inputs, TorchFunction, deck_function
from hipace_tpu_torch.pipeline.simulation import Simulation
from hipace_tpu_torch.utils.atomic_data import (ATOMIC_WEIGHTS_DA,
                                               IONIZATION_ENERGIES_EV)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"hipace_tpu", "jax", "jaxlib", "tools"}


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_torch_step.py"),
             os.path.join(ROOT, "tools", "time_torch_kernels.py"),
             os.path.join(ROOT, "tools", "laser_f32_drift.py"),
             os.path.join(ROOT, "tools", "f32_sums_probe.py"),
             os.path.join(ROOT, "tools", "pipeline_cards.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "hipace_tpu_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_walk_finds_the_port():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"chip_smoke.py", "hipace_tpu_torch/parser.py",
            "hipace_tpu_torch/geometry.py", "hipace_tpu_torch/constants.py",
            "hipace_tpu_torch/utils/atomic_data.py",
            "hipace_tpu_torch/ops/mg_kernel.py", "hipace_tpu_torch/bench.py",
            "hipace_tpu_torch/gpu_check.py",
            "hipace_tpu_torch/parallel/ranks.py",
            "tools/pipeline_cards.py"} <= names


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT)
                                  for p in _port_sources()])
def test_no_import_of_the_jax_package(path):
    assert not _imported_roots(os.path.join(ROOT, path)) & FORBIDDEN


def test_cpu_cli_run_leaves_the_jax_package_unimported(tmp_path):
    deck = tmp_path / "deck"
    deck.write_text(__graft_entry__._DECK.format(nxy=15, nz=4, npart=200))
    code = (
        "import sys\n"
        "from hipace_tpu_torch.__main__ import main\n"
        f"assert main([{str(deck)!r}, 'hipace.verbose=0', '--device=cpu']) "
        "== 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('hipace_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('STANDS_ALONE_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STANDS_ALONE_OK" in out.stdout
    assert "Finished Evolve" in out.stdout and "on cpu" in out.stdout


# ------------------------------------------------- the card is the default
def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_simulation_without_a_device_argument_needs_the_card():
    _no_card()
    deck = Inputs(__graft_entry__._DECK.format(nxy=15, nz=4, npart=200))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(deck, verbose=0)
    sim = Simulation(deck, device="cpu", verbose=0)
    assert sim.device.type == "cpu" and sim.dtype == torch.float64


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"],
                                  ["--device=cuda"]])
def test_cli_without_cpu_request_needs_the_card(tmp_path, argv):
    _no_card()
    from hipace_tpu_torch.__main__ import main
    deck = tmp_path / "deck"
    deck.write_text(__graft_entry__._DECK.format(nxy=15, nz=4, npart=200))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(deck), "hipace.verbose=0"] + argv)


# ------------------------------------------------------ the port's copies
NORMALIZED = __graft_entry__._DECK.format(nxy=31, nz=8, npart=1000)
SI = """
amr.n_cell = 31 27 8
my_constants.ne = 1.25e24
my_constants.wp = sqrt(ne * q_e^2 / (epsilon0 * m_e))
my_constants.kp_inv = clight / wp
my_constants.nz = 8
max_step = 2
hipace.dt = 20. / wp
hipace.depos_order_xy = 3
boundary.field = Periodic
geometry.prob_lo = -4.*kp_inv -4.*kp_inv -6.*kp_inv   # a comment
geometry.prob_hi =  4.*kp_inv  4.*kp_inv  2.*kp_inv
beams.names = beam
beam.profile = gaussian
beam.position_std = 0.3*kp_inv 0.3*kp_inv 1.41*kp_inv
beam.density = 3.*ne
hipace.file_prefix = "out_{nz}_{2*nz}"
"plasma.density(x,y,z)" = "ne * if(x^2 + y^2 < kp_inv^2, 1., \\
    0.5) * exp(-z^2 / (8. * kp_inv^2))"
plasma.ppc = 2 1
plasma.do_something = true
"""
OVERRIDES = ("amr.n_cell = 63 63 16", "my_constants.ne=2.5e24",
             "beam.profile=can")
DECKS = {"normalized": (NORMALIZED, ()), "SI": (SI, ()),
         "SI with overrides": (SI, OVERRIDES)}


@pytest.mark.parametrize("deck", DECKS)
def test_inputs_match_the_jax_package(deck):
    text, overrides = DECKS[deck]
    ref, got = JInputs(text, overrides), Inputs(text, overrides)
    assert got._raw == ref._raw
    assert got._funcs == ref._funcs
    assert got.my_constants == ref.my_constants
    for key in ref._raw:
        if "(" in key:
            continue
        assert got.contains(key) and got.raw(key) == ref.raw(key)
        assert got.get(key, str) == ref.get(key, str), key
        assert got.query_list(key, [], str) == ref.query_list(key, [], str)
    for key in ("amr.n_cell", "geometry.prob_lo", "geometry.prob_hi"):
        assert got.get_list(key, float) == ref.get_list(key, float)
    assert got.get_list("amr.n_cell", int) == ref.get_list("amr.n_cell", int)
    assert got.query("max_step", 0, int) == ref.query("max_step", 0, int)
    assert got.query("hipace.dt", 0.0) == ref.query("hipace.dt", 0.0)
    assert got.query("plasma.do_something", False, bool) == ref.query(
        "plasma.do_something", False, bool)
    assert got.query("not.there", 7) == ref.query("not.there", 7) == 7
    assert not got.contains("not.there")
    with pytest.raises(KeyError):
        got.get("not.there")
    view, rview = got.prefix("beam"), ref.prefix("beam")
    assert view.query("profile", "", str) == rview.query("profile", "", str)
    assert view.contains("profile") and not view.contains("radius")
    assert got._queried == ref._queried


def test_inputs_override_and_file(tmp_path):
    ref, got = JInputs(SI), Inputs(SI)
    for inp in (ref, got):
        inp.override("my_constants.ne", "5e23")
        inp.override("beam.profile", "can")
    assert got.my_constants == ref.my_constants
    assert got._raw == ref._raw
    path = tmp_path / "deck"
    path.write_text(SI)
    assert Inputs.from_file(str(path), OVERRIDES)._raw == JInputs.from_file(
        str(path), OVERRIDES)._raw
    with pytest.raises(ValueError, match="my_constants"):
        Inputs("my_constants.a = b + 1\n")


@pytest.mark.parametrize("deck", DECKS)
def test_function_valued_keys_match_the_jax_package(deck):
    """The port's TorchFunction against the JAX package's get_function on
    the same deck entry, and the default expression where the key is
    absent."""
    text, overrides = DECKS[deck]
    ref, got = JInputs(text, overrides), Inputs(text, overrides)
    rng = np.random.default_rng(0)
    scale = 1.0 if deck == "normalized" else ref.my_constants["kp_inv"]
    x, y, z = scale * rng.standard_normal((3, 40))
    args = ("x", "y", "z")
    want = np.broadcast_to(np.asarray(
        ref.get_function("plasma.density", args)(x, y, z)), x.shape)
    fn = got.get_function("plasma.density", args)
    assert isinstance(fn, TorchFunction)
    t = [torch.tensor(a) for a in (x, y, z)]
    np.testing.assert_allclose(fn(*t).numpy(), want, rtol=1e-14)
    same = deck_function(got, ("missing.density", "plasma.density"), args)
    np.testing.assert_array_equal(same(*t).numpy(), fn(*t).numpy())
    assert got.get_function("missing.density", args) is None
    assert deck_function(got, ("missing.density",), args) is None
    dflt = got.prefix("missing").get_function("density", args, "2.*x")
    np.testing.assert_array_equal(dflt(*t).numpy(), 2.0 * x)
    assert got._queried >= {"plasma.density()", "missing.density()"}


@pytest.mark.parametrize("deck", DECKS)
@pytest.mark.parametrize("order", [2, 3])
def test_geometry_matches_the_jax_package(deck, order):
    text, overrides = DECKS[deck]
    ref = JGeometry.from_inputs(JInputs(text, overrides), order)
    got = Geometry.from_inputs(Inputs(text, overrides), order)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for name in ("nx", "ny", "nz", "dx", "dy", "dz", "x_pos_offset",
                 "y_pos_offset", "z_pos_offset", "slice_shape"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.z_of_slice(3) == ref.z_of_slice(3)
    assert hash(got) == hash(Geometry(**dataclasses.asdict(got)))


@pytest.mark.parametrize("normalized", [True, False])
def test_constants_match_the_jax_package(normalized):
    got = tconstants.make_constants(normalized)
    ref = jconstants.make_constants(normalized)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(got, tconstants.PhysConst)
    names = [n for n in dir(jconstants) if n.startswith("SI_") or n == "PI"]
    assert len(names) == 9
    for name in names:
        assert getattr(tconstants, name) == getattr(jconstants, name), name
    assert tconstants.plasma_frequency_SI(1e24) == \
        jconstants.plasma_frequency_SI(1e24)


def test_atomic_weights_match_the_jax_package():
    assert ATOMIC_WEIGHTS_DA == JWEIGHTS and len(ATOMIC_WEIGHTS_DA) == 20


def test_ionization_energies_match_the_jax_package():
    assert IONIZATION_ENERGIES_EV == JENERGIES
    assert len(IONIZATION_ENERGIES_EV) == 20


# ------------------------------------------- host side of the K3 launch
@pytest.mark.parametrize("n,C,itemsize,want_lc", [
    (1023, 2, 4, 5), (1023, 2, 8, 5), (1023, 1, 4, 4), (63, 2, 4, 1),
    (31, 2, 8, 0), (7, 1, 4, 0)])
def test_multigrid_plan_picks_the_first_level_that_fits(n, C, itemsize,
                                                        want_lc):
    mg = MultiGrid(n, n, 0.1, 0.1)
    halo, lc, smem = mg_kernel.plan(mg.shapes, C, itemsize, 2, 2)
    assert (halo, lc) == (6, want_lc)
    cells = [h * w for h, w in mg.shapes]
    ladder = itemsize * ((2 * C + 2) * sum(cells[lc:]) + C * cells[lc])
    assert ladder <= smem <= mg_kernel.MAX_SMEM
    if lc:
        bigger = itemsize * ((2 * C + 2) * sum(cells[lc - 1:])
                             + C * cells[lc - 1])
        assert bigger > mg_kernel.MAX_SMEM // mg_kernel.BLOCKS_PER_SM[
            itemsize] - 1024


def test_multigrid_plan_rejects_sweeps_that_leave_no_tile():
    mg = MultiGrid(255, 255, 0.1, 0.1)
    assert mg_kernel.plan(mg.shapes, 2, 4, 1, 3)[0] == 8
    with pytest.raises(ValueError, match="tile"):
        mg_kernel.plan(mg.shapes, 2, 4, 2, 12)


@pytest.mark.parametrize("scalar_acf", [False, True])
@pytest.mark.parametrize("nx,ny,C", [(1023, 511, 1), (255, 255, 2),
                                     (31, 31, 2)])
def test_multigrid_layout_buffers_do_not_overlap(nx, ny, C, scalar_acf):
    mg = MultiGrid(nx, ny, 0.1, 0.1)
    lay = mg_kernel._layout(mg, C, 4, 2, 2, scalar_acf)
    assert mg_kernel._layout(mg, C, 4, 2, 2, scalar_acf) is lay
    rows = mg_kernel.TABLE_ROWS
    spans = []
    for name, row in rows.items():
        for lev, (h, w) in enumerate(mg.shapes):
            off = lay.offsets[row, lev]
            wanted = {"A": lev < lay.Lc, "B": 1 <= lev <= lay.Lc,
                      "rhs": 1 <= lev <= lay.Lc,
                      "acf": 1 <= lev <= lay.Lc or (lev == 0 and scalar_acf)
                      }[name]
            assert (off >= 0) == wanted, (name, lev)
            if wanted:
                spans.append((off, off + (1 if name == "acf" else C) * h * w))
    spans.sort()
    if not spans:       # the whole ladder runs in one block: no scratch
        assert lay.Lc == 0 and lay.total == 0
        return
    assert spans[0][0] == 0 and spans[-1][1] == lay.total
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end == start


def test_plain_solve_keeps_its_cycle_count_an_int():
    mg = MultiGrid(31, 31, 0.1, 0.1)
    rhs = torch.tensor(np.random.default_rng(1).standard_normal((2, 31, 31)))
    mg.solve(torch.zeros_like(rhs), rhs, 0.5)
    assert type(mg.cycles) is int and mg.last_cycles == mg.cycles > 0


def test_step_returns_the_cycle_counts_as_ints():
    sim = Simulation(Inputs(__graft_entry__._DECK.format(nxy=15, nz=4,
                                                         npart=200)),
                     device="cpu", verbose=0)
    cycles = sim.run_step(0)["mg_cycles"]
    assert len(cycles) == 4 and all(type(c) is int for c in cycles)


# ------------------------------------------- host side of the K1 launch
def test_the_lattice_hint_does_not_change_the_sums():
    rng = np.random.default_rng(2)
    ym = torch.tensor(rng.uniform(2, 20, 300))
    xm = torch.tensor(rng.uniform(2, 20, 300))
    vals = torch.tensor(rng.standard_normal((2, 300)))
    zero = torch.zeros((2, 24, 24), dtype=torch.float64)
    ref = tdeposit.deposit(zero.clone(), ym, xm, vals, 2)
    for width in (None, 20, 7):
        got = tdeposit.deposit(zero.clone(), ym, xm, vals, 2,
                               lattice_width=width)
        assert torch.equal(got, ref)


def test_deposit_kernel_refuses_cpu_tensors():
    z = torch.zeros((1, 8, 8), dtype=torch.float64)
    one = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tdeposit.deposit_cuda(z, 3 * one, 3 * one, one[None], 2)
    mg = MultiGrid(15, 15, 0.1, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        mg_kernel.mg_solve(mg, torch.zeros(15, 15, dtype=torch.float64),
                           torch.ones(15, 15, dtype=torch.float64), 0.0)
