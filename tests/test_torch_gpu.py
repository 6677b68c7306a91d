"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Marked ``gpu``: they build the kernels with nvcc and need a CUDA device, so
they skip on a CPU-only machine. On the GPU machine, which has no JAX, run
them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances are relative to the largest output: float64 1e-12 and float32
1e-5 for the atomic deposit and the gather (summation order), 1e-9 / 1e-4
for the multigrid (roundoff carried through the V-cycles).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype, f64, f32):
    return f64 if dtype == torch.float64 else f32


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order,deriv_type,blocks", [
    (0, -1, None), (1, -1, None), (2, -1, None), (3, -1, None),
    (2, 2, None), (2, 0, (("w", "w", 1), ("dw", "w", 1), ("w", "dw", 1))),
    (3, 1, (("dw", "w", 2), ("w", "dw", 1)))])
def test_deposit_kernel(cuda, dtype, order, deriv_type, blocks):
    from hipace_tpu_torch.ops.deposit import deposit_cuda, deposit_plain
    rng = np.random.default_rng(order + 4 * (deriv_type + 1))
    NY, NX, N, C = 70, 66, 20000, 3
    ym = torch.tensor(rng.uniform(-3, NY + 3, N), dtype=dtype, device=cuda)
    xm = torch.tensor(rng.uniform(-3, NX + 3, N), dtype=dtype, device=cuda)
    ym[::11] = 2.0 * NY
    vals = torch.tensor(rng.standard_normal((C, N)), dtype=dtype,
                        device=cuda)
    zero = torch.zeros((C, NY, NX), dtype=dtype, device=cuda)
    got = deposit_cuda(zero.clone(), ym, xm, vals, order, deriv_type, blocks)
    ref = deposit_plain(zero.clone(), ym, xm, vals, order, deriv_type,
                        blocks)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("form", ["stack", "planes"])
def test_gather_kernel(cuda, dtype, order, form):
    """Orders 0-3 with lanes past every grid edge, from a (5, NY, NX) stack
    or from five separate planes."""
    from hipace_tpu_torch.ops.gather import gather_main_cuda, gather_main_plain
    rng = np.random.default_rng(order)
    NY, NX, N = 70, 66, 20000
    ym = torch.tensor(rng.uniform(-3, NY + 3, N), dtype=dtype, device=cuda)
    xm = torch.tensor(rng.uniform(-3, NX + 3, N), dtype=dtype, device=cuda)
    ym[::7] = 2.0 * NY
    stack = torch.tensor(rng.standard_normal((5, NY, NX)), dtype=dtype,
                         device=cuda)
    planes = stack if form == "stack" else [p.clone() for p in stack]
    got = gather_main_cuda(planes, ym, xm, order)
    ref = gather_main_plain(planes, ym, xm, order)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)
    assert bool((got[:, ::7] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["lattice hint", "no hint", "shuffled",
                                  "far with hint", "wrong hint"])
def test_deposit_kernel_tile_and_direct_paths(cuda, dtype, case):
    """Lattice-ordered lanes fill shared-memory tiles; shuffled or far-moved
    lanes overflow them and take the in-kernel direct path. The sums are
    the same whatever the hint."""
    from hipace_tpu_torch.ops import deposit as dep
    rng = np.random.default_rng(5)
    ny = nx = 100
    G, C = 2, 13
    NY, NX = ny + 2 * G, nx + 2 * G
    N = ny * nx
    iy, ix = np.divmod(np.arange(N), nx)
    spread = 40.0 if case == "far with hint" else 0.5
    ym = iy + G + rng.uniform(-spread, spread, N)
    xm = ix + G + rng.uniform(-spread, spread, N)
    ym[::97] = 2.0 * NY
    vals = rng.standard_normal((C, N))
    if case == "shuffled":
        perm = rng.permutation(N)
        ym, xm, vals = ym[perm], xm[perm], np.ascontiguousarray(vals[:, perm])
    width = {"lattice hint": nx, "far with hint": nx, "wrong hint": 37}.get(
        case)
    ym, xm, vals = (torch.tensor(a, dtype=dtype, device=cuda)
                    for a in (ym, xm, vals))
    zero = torch.zeros((C, NY, NX), dtype=dtype, device=cuda)
    dep.reset_block_counts()
    got = dep.deposit_cuda(zero.clone(), ym, xm, vals, 2, 2,
                           lattice_width=width)
    direct, blocks = dep.direct_block_count(cuda), dep.deposit.blocks
    ref = dep.deposit_plain(zero.clone(), ym, xm, vals, 2, 2)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)
    assert 0 <= direct <= blocks and blocks > 0
    if case == "lattice hint":
        assert direct == 0
    if case in ("shuffled", "far with hint"):
        assert direct > blocks // 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["lattice order", "shuffled", "far",
                                  "beam"])
def test_gather_kernel_lane_orders(cuda, dtype, case):
    """The plasma's lanes in lattice order, the same shuffled, moved by up
    to 40 cells, and a beam-like gaussian: the same sums in any order, and
    dead lanes read 0."""
    from hipace_tpu_torch.ops import gather as gat
    rng = np.random.default_rng(6)
    ny = nx = 100
    G = 2
    NY, NX = ny + 2 * G, nx + 2 * G
    if case == "beam":
        N = 3000
        ym = rng.normal(NY / 2, 5.0, N)
        xm = rng.normal(NX / 2, 5.0, N)
    else:
        N = ny * nx
        iy, ix = np.divmod(np.arange(N), nx)
        spread = 40.0 if case == "far" else 0.5
        ym = iy + G + rng.uniform(-spread, spread, N)
        xm = ix + G + rng.uniform(-spread, spread, N)
    ym[::97] = 2.0 * NY
    if case == "shuffled":
        perm = rng.permutation(N)
        ym, xm = ym[perm], xm[perm]
    ym, xm = (torch.tensor(a, dtype=dtype, device=cuda) for a in (ym, xm))
    planes = [torch.tensor(rng.standard_normal((NY, NX)), dtype=dtype,
                           device=cuda) for _ in range(5)]
    got = gat.gather_main_cuda(planes, ym, xm, 2)
    ref = gat.gather_main_plain(planes, ym, xm, 2)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)
    assert bool((got[:, ym >= 1.5 * NY] == 0).all())


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    """Planes of another dtype, device or shape, a plane that is not
    contiguous, four planes, a stack that is not (5, NY, NX) or not
    contiguous, an order past 3: the wrapper raises."""
    from hipace_tpu_torch.ops.gather import gather_main_cuda
    pos = torch.full((4,), 5.0, device=cuda)
    planes = [torch.zeros((12, 12), device=cuda) for _ in range(5)]
    bad = [
        planes[:4] + [planes[4].double()],
        planes[:4] + [planes[4].cpu()],
        planes[:4] + [torch.zeros((12, 13), device=cuda)],
        planes[:4] + [torch.zeros((12, 24), device=cuda)[:, ::2]],
        planes[:4],
        torch.zeros((4, 12, 12), device=cuda),
        torch.zeros((12, 12), device=cuda),
        torch.zeros((5, 12, 24), device=cuda)[:, :, ::2],
    ]
    for pl in bad:
        with pytest.raises(ValueError):
            gather_main_cuda(pl, pos, pos, 2)
    with pytest.raises(ValueError):
        gather_main_cuda(planes, pos, pos, 4)
    with pytest.raises(ValueError):
        gather_main_cuda(planes, pos.double(), pos.double(), 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ny,nx,nchan,acf_kind,max_iters", [
    (31, 31, 2, "2-D", 40), (63, 31, 1, "2-D", 40), (15, 127, 2, "2-D", 40),
    (95, 63, 2, "2-D", 40), (95, 63, 1, "scalar", 40),
    (255, 255, 2, "2-D", 40), (255, 255, 1, "scalar", 40),
    (255, 255, 0, "2-D", 40), (255, 255, 2, "2-D", 1),
    (1023, 511, 1, "2-D", 40), (1023, 511, 2, "scalar", 1)])
def test_multigrid_kernel(cuda, dtype, ny, nx, nchan, acf_kind, max_iters):
    """One cooperative launch per solve, the plain version's V-cycle count,
    on grids that are not multiples of the kernel's tile; nchan 0 is the
    unbatched (ny, nx) system."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    rng = np.random.default_rng(ny + nx)
    mg = MultiGrid(nx, ny, 0.05, 0.07, device=cuda, dtype=dtype)
    shape = (nchan, ny, nx) if nchan else (ny, nx)
    rhs = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    acf = torch.tensor(np.abs(rng.standard_normal((ny, nx))), dtype=dtype,
                       device=cuda) if acf_kind == "2-D" else 0.75
    u0 = torch.zeros_like(rhs)
    before = (mg_solve.launches, mg_solve.kernel_launches)
    got, cycles, resnorm = mg_solve(mg, u0, rhs, acf, tol_rel=1e-4,
                                    max_iters=max_iters)
    assert mg_solve.launches == before[0] + 1
    assert mg_solve.kernel_launches == before[1] + 1
    ref = mg.solve_plain(u0, rhs, acf, tol_rel=1e-4, max_iters=max_iters)
    torch.cuda.synchronize()
    assert int(cycles) == mg.last_cycles > 0
    if max_iters == 1:
        assert int(cycles) == 1
    assert _rel(got, ref) < _tol(dtype, 1e-9, 1e-4)
    res = (rhs - mg.apply_op(got, acf)).abs().max()
    assert abs(float(resnorm) - float(res)) <= 1e-3 * float(res)


def test_multigrid_solve_sends_cuda_tensors_to_the_kernel(cuda):
    """MultiGrid.solve keeps the kernel's count on the device; last_cycles
    reads it. A converged first guess takes no V-cycle and comes back
    unchanged; NaNs end the solve at once, as in the plain version."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    rng = np.random.default_rng(3)
    mg = MultiGrid(127, 127, 0.05, 0.07, device=cuda, dtype=torch.float64)
    rhs = torch.tensor(rng.standard_normal((2, 127, 127)), device=cuda)
    before = mg_solve.launches
    u = mg.solve(torch.zeros_like(rhs), rhs, 0.5)
    assert mg_solve.launches == before + 1
    assert torch.is_tensor(mg.cycles) and mg.cycles.device.type == "cuda"
    assert mg.last_cycles > 0
    again = mg.solve(u, rhs, 0.5, tol_rel=1e-2)
    assert mg.last_cycles == 0 and torch.equal(again, u)
    bad = rhs.clone()
    bad[0, 5, 5] = float("nan")
    mg.solve(torch.zeros_like(rhs), bad, 0.5)
    assert mg.last_cycles == 0


def test_kernels_count_launches(cuda):
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    pos = torch.full((4,), 5.0, device=cuda)
    before = (deposit.launches, gather_main.launches)
    deposit(torch.zeros((1, 12, 12), device=cuda), pos, pos,
            torch.ones((1, 4), device=cuda), 2)
    gather_main(torch.zeros((5, 12, 12), device=cuda), pos, pos, 2)
    gather_main([torch.zeros((12, 12), device=cuda)] * 5, pos, pos, 2)
    # no lanes, no launch, no count
    empty = pos[:0]
    deposit(torch.zeros((1, 12, 12), device=cuda), empty, empty,
            torch.ones((1, 0), device=cuda), 2)
    gather_main(torch.zeros((5, 12, 12), device=cuda), empty, empty, 2)
    assert (deposit.launches, gather_main.launches) == (before[0] + 1,
                                                        before[1] + 2)


def test_pc_open_step_on_the_card_matches_the_cpu(cuda):
    """A 63^2 x 16 float64 predictor-corrector step with open boundaries
    on the kernels against the CPU plain path from the same beam: fields
    within 1e-8 and equal iterations on every slice."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import pc_open
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(pc_open(63, 16, 4000), device="cpu", verbose=0)
    gpu = Simulation(pc_open(63, 16, 4000), device=cuda,
                     dtype=torch.float64, verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time)
    ref, got = cpu.run_step(0), gpu.run_step(0)
    assert got["pc_iters"] == ref["pc_iters"]
    assert _rel(got["diag"].cpu(), ref["diag"]) < 1e-8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monopole", [True, False])
def test_open_boundary_on_the_card_matches_the_cpu(cuda, dtype, monopole):
    from hipace_tpu_torch.fields.open_boundary import OpenBoundary
    from hipace_tpu_torch.geometry import Geometry
    g = Geometry(n_cell=(63, 47, 4), prob_lo=(-3.0, -5.0, -2.0),
                 prob_hi=(6.0, 4.0, 2.0))
    rng = np.random.default_rng(11)
    rhs = torch.tensor(rng.standard_normal((3, 47, 63)) + 0.5)
    ref = OpenBoundary(g, device="cpu").apply(rhs, monopole)
    got = OpenBoundary(g, device=cuda, dtype=dtype).apply(
        rhs.to(device=cuda, dtype=dtype), monopole)
    assert _rel(got.cpu().double(), ref) < _tol(dtype, 1e-12, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["MGDirichlet", "FFTPeriodic"])
def test_poisson_solvers_on_the_card_match_the_cpu(cuda, dtype, name):
    """MGDirichlet runs K3 on the card (V-cycles to a 1e-11 relative
    residual: all 40 in float32), FFTPeriodic cuFFT."""
    from hipace_tpu_torch.fields.poisson import make_poisson_solver
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    g = Geometry(n_cell=(127, 63, 4), prob_lo=(-4.0, -2.0, -2.0),
                 prob_hi=(4.0, 2.0, 2.0))
    rng = np.random.default_rng(12)
    rhs = torch.tensor(rng.standard_normal((3, 63, 127)))
    host = make_poisson_solver(name, g, "cpu", torch.float64)
    card = make_poisson_solver(name, g, cuda, dtype)
    before = mg_solve.launches
    got = card.solve(rhs.to(device=cuda, dtype=dtype))
    ref = host.solve(rhs)
    if name == "MGDirichlet":
        assert mg_solve.launches == before + 1
        if dtype == torch.float64:
            assert card.mg.last_cycles == host.mg.last_cycles
        else:
            assert card.mg.last_cycles == 40
    assert _rel(got.cpu().double(), ref) < _tol(dtype, 1e-9, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ny,nx,nchan,acf_kind,max_iters", [
    (32, 32, 2, "2-D", 40), (32, 64, 3, "scalar", 40), (64, 96, 2, "2-D", 40),
    (64, 96, 1, "scalar", 40), (256, 256, 2, "2-D", 40),
    (256, 256, 0, "2-D", 40), (256, 256, 2, "2-D", 1),
    (512, 1024, 2, "2-D", 40), (1024, 1024, 3, "scalar", 40)])
def test_multigrid_kernel_cell_centered(cuda, dtype, ny, nx, nchan, acf_kind,
                                        max_iters):
    """The cell-centered levels (even sizes): one cooperative launch per
    solve and the plain version's V-cycle count; the 2x2 average, the
    injection and the 4/3 edge stencil round as the plain version's do
    (1e-12 / 1e-5). 96 stops the ladder at 3 cells, the others go down to
    2."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    rng = np.random.default_rng(ny + nx + 1)
    mg = MultiGrid(nx, ny, 0.05, 0.07, device=cuda, dtype=dtype)
    assert mg.cell_centered and min(mg.shapes[-1]) == 2
    shape = (nchan, ny, nx) if nchan else (ny, nx)
    rhs = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    acf = torch.tensor(np.abs(rng.standard_normal((ny, nx))), dtype=dtype,
                       device=cuda) if acf_kind == "2-D" else 0.0
    u0 = torch.zeros_like(rhs)
    kw = {"tol_rel": 1e-4 if acf_kind == "2-D" else 1e-11,
          "max_iters": max_iters}
    before = (mg_solve.launches, mg_solve.kernel_launches)
    got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kw)
    assert mg_solve.launches == before[0] + 1
    assert mg_solve.kernel_launches == before[1] + 1
    ref = mg.solve_plain(u0, rhs, acf, **kw)
    torch.cuda.synchronize()
    assert int(cycles) == mg.last_cycles > 0
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)


@pytest.mark.parametrize("extra", ["", "hipace.plasma_pusher = ab5\n",
                                   "hipace.depos_derivative_type = 0\n",
                                   "hipace.depos_derivative_type = 1\n"])
def test_even_step_on_the_card_matches_the_cpu(cuda, extra):
    """A 64^2 x 16 float64 step of the two-species ION_MOTION_EVEN deck
    (cell-centered Bx/By on K3) on the kernels against the CPU plain path
    from the same beam and the same temperature draws: fields within 1e-8,
    equal V-cycles on every slice."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import ion_motion_even
    from hipace_tpu_torch.particles import plasma as pl
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(ion_motion_even(64, 16, 4000, extra), device="cpu",
                     verbose=0)
    gpu = Simulation(ion_motion_even(64, 16, 4000, extra), device=cuda,
                     dtype=torch.float64, verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time)
    draws = [pl.plasma_draws(p, cpu.geom, cpu.generator, "cpu",
                             torch.float64) for p in cpu.plasma_cfgs]
    assert draws[0] is not None and draws[1] is None
    orig = pl.plasma_draws
    try:
        it = iter(draws + draws)
        pl.plasma_draws = lambda cfg, g, gen, device, dtype: (
            lambda d: None if d is None else d.to(device))(next(it))
        ref, got = cpu.run_step(0), gpu.run_step(0)
    finally:
        pl.plasma_draws = orig
    assert got["mg_cycles"] == ref["mg_cycles"]
    assert _rel(got["diag"].cpu(), ref["diag"]) < 1e-8


# external fields in both forms (E under beams., the witness's own B) with
# a t dependence, spin_anom from beams.
BEAM_EXTRA = ("beams.external_E(x,y,z,t) = 0.02*x*(1.+0.1*t) 0.02*y 0.01\n"
              "witness.external_B(x,y,z,t) = 0.01*y\nbeams.spin_anom = 0.1\n")


def _beam_lanes(sim, n, nbeams, seed):
    """One slice's lanes over the box, some slipped, some dead, resume
    counters 0-3, species at random, unit spins, as float64 numpy."""
    rng = np.random.default_rng(seed)
    g = sim.geom
    lo = g.prob_lo[2] + 3 * g.dz
    s = rng.standard_normal((3, n))
    s = s / np.linalg.norm(s, axis=0)
    return {"x": rng.uniform(-6, 6, n), "y": rng.uniform(-6, 6, n),
            "z": rng.uniform(lo - 0.2 * g.dz, lo + g.dz, n),
            "ux": rng.normal(0, 3, n), "uy": rng.normal(0, 3, n),
            "uz": 2000 + rng.normal(0, 20, n), "w": rng.uniform(0.5, 1.5, n),
            "valid": rng.random(n) < 0.9,
            "nsub": rng.integers(0, 4, n).astype(np.int32),
            "beam_id": rng.integers(0, nbeams, n).astype(np.int32),
            "sx": s[0], "sy": s[1], "sz": s[2]}, lo


def test_beam_push_on_the_card_matches_the_cpu(cuda):
    """Both beams of DRIVE_WITNESS pushed through one slice in float64 with
    external fields, the witness's spin and radiation reaction, on K2
    against the CPU plain path: within 1e-12, the same lanes and
    counters."""
    from hipace_tpu_torch.decks import drive_witness
    from hipace_tpu_torch.particles import beam as bm
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(drive_witness(31, 8, 1000, BEAM_EXTRA), device="cpu",
                     verbose=0)
    wit = sim.beam_cfgs[1]
    assert wit.do_spin_tracking and wit.do_radiation_reaction
    assert all(b.use_external_fields for b in sim.beam_cfgs)
    lanes, min_z = _beam_lanes(sim, 4000, 2, 11)
    rng = np.random.default_rng(12)
    NY, NX = sim.geom.slice_shape
    planes = {k: 0.5 * rng.standard_normal((NY, NX))
              for k in ("Psi", "Ez", "Bx", "By", "Bz")}
    out = []
    for dev in ("cpu", cuda):
        out.append(bm.advance_all_beams(
            {k: torch.as_tensor(v, device=dev) for k, v in lanes.items()},
            {k: torch.as_tensor(v, device=dev) for k, v in planes.items()},
            sim.geom, sim.beam_cfgs, sim.pc, 1.0, min_z,
            time=torch.tensor(0.7, dtype=torch.float64, device=dev),
            background_density_SI=sim.cfg.background_density_SI,
            external=bm.beam_constants(sim.beam_cfgs, dev,
                                       torch.float64)["external"]))
    ref, got = out
    for k in ("valid", "nsub", "beam_id"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    for k in bm.BEAM_ATTRS:
        assert _rel(got[k].cpu(), ref[k]) < 1e-12, k


def _push_lanes(sim, n, seed):
    """_beam_lanes of two species, a third of them moved to within half a
    cell of the box's transverse edges with transverse momenta that carry
    many across; numpy, float64."""
    g = sim.geom
    bp, min_z = _beam_lanes(sim, n, 2, seed)
    rng = np.random.default_rng(seed + 1)
    edge = rng.random(n) < 1 / 3
    for k, lo, hi in (("x", g.prob_lo[0], g.prob_hi[0]),
                      ("y", g.prob_lo[1], g.prob_hi[1])):
        side = np.where(rng.random(n) < 0.5, lo, hi)
        bp[k] = np.where(edge, side + rng.uniform(-0.5, 0.5, n) * g.dx,
                         bp[k])
    for k in ("ux", "uy"):
        bp[k] = np.where(edge, 60.0 * rng.standard_normal(n), bp[k])
    return bp, min_z


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("boundary", ["Periodic", "Reflecting", "Absorbing"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_beam_push_kernel(cuda, dtype, boundary, order):
    """The fused beam push against its plain version (the subcycle loop) on
    the card: lanes across the box's edges, resume counters 0-3, lanes
    below min_z, dead lanes, every lane or one species of two, with and
    without do_z_push. valid and nsub must be equal lane by lane. The floats
    must lie within K2's tolerances in chip_smoke.py of each attribute's
    largest value, 1e-12 in float64 and 1e-5 in float32: the kernel rounds
    the push as the loop's ops do, but its gather's sums are K2's code,
    inlined, whose multiply-adds the compiler may contract otherwise than in
    K2's own kernel."""
    from hipace_tpu_torch.decks import drive_witness
    from hipace_tpu_torch.ops.beam_push import (beam_push_cuda,
                                                beam_push_plain)
    from hipace_tpu_torch.particles import beam as bm
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(drive_witness(31, 8, 1000), device="cpu", verbose=0)
    lanes, min_z = _push_lanes(sim, 6000, 20 + order)
    rng = np.random.default_rng(30 + order)
    NY, NX = sim.geom.slice_shape
    planes = {k: torch.tensor(0.5 * rng.standard_normal((NY, NX)),
                              dtype=dtype, device=cuda)
              for k in ("Psi", "Ez", "Bx", "By", "Bz")}
    bp = {k: torch.as_tensor(v, device=cuda) for k, v in lanes.items()}
    bp = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in bp.items()}
    tol = _tol(dtype, 1e-12, 1e-5)
    for species, z_push in ((None, True), (1, True), (0, False)):
        cfg = dataclasses.replace(sim.beam_cfgs[0],
                                  particle_boundary=boundary,
                                  do_z_push=z_push)
        got = beam_push_cuda(bp, planes, sim.geom, cfg, sim.pc, 1.0, min_z,
                             order, species)
        mask = None if species is None else bp["beam_id"] == species
        ref = beam_push_plain(bp, planes, sim.geom, cfg, sim.pc, 1.0, min_z,
                              order, species_mask=mask)
        torch.cuda.synchronize()
        for k in ("valid", "nsub", "beam_id"):
            assert torch.equal(got[k], ref[k]), (species, k)
        for k in bm.BEAM_ATTRS:
            assert got[k].dtype == dtype
            assert _rel(got[k], ref[k]) <= tol, (species, k)
        moved = got["uz"] != bp["uz"]
        assert int(moved.sum()) > 1000
        if mask is not None:
            assert not bool(moved[~mask].any())
        if not z_push:
            assert torch.equal(got["z"], bp["z"])
        # lanes stopped below min_z keep a counter to resume from
        assert int((got["valid"] & (got["nsub"] > 0)).sum()) > 0


def test_beam_push_counts_launches(cuda):
    """DRIVE_WITNESS's drive beam is one launch of the fused push, its
    witness (spin, radiation reaction) one push of the loop; an empty slice
    launches nothing and comes back empty."""
    from hipace_tpu_torch.decks import drive_witness
    from hipace_tpu_torch.ops.beam_push import beam_push, beam_push_cuda
    from hipace_tpu_torch.particles import beam as bm
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(drive_witness(31, 8, 1000), device="cpu", verbose=0)
    lanes, min_z = _beam_lanes(sim, 4000, 2, 14)
    bp = {k: torch.as_tensor(v, device=cuda) for k, v in lanes.items()}
    NY, NX = sim.geom.slice_shape
    planes = {k: torch.zeros((NY, NX), dtype=torch.float64, device=cuda)
              for k in ("Psi", "Ez", "Bx", "By", "Bz")}
    before = (beam_push.launches, bm.advance_beam_slice.general_calls)
    bm.advance_all_beams(bp, planes, sim.geom, sim.beam_cfgs, sim.pc, 1.0,
                         min_z,
                         background_density_SI=sim.cfg.background_density_SI)
    assert (beam_push.launches, bm.advance_beam_slice.general_calls) == (
        before[0] + 1, before[1] + 1)
    empty = {k: v[:0] for k, v in bp.items()}
    out = beam_push_cuda(empty, planes, sim.geom, sim.beam_cfgs[0], sim.pc,
                         1.0, min_z)
    torch.cuda.synchronize()
    assert beam_push.launches == before[0] + 1
    assert all(out[k].numel() == 0 for k in bm.ALL_ATTRS)


def test_two_beam_deposit_on_the_card_matches_the_cpu(cuda):
    """One K1 deposit of jx, jy, jz and rho - jz/c over two beams' lanes,
    each lane with its species' charge (a proton witness), in float64."""
    from hipace_tpu_torch.decks import drive_witness
    from hipace_tpu_torch.particles import beam as bm
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(drive_witness(31, 8, 1000, "witness.element = proton\n"),
                     device="cpu", verbose=0)
    assert [b.charge for b in sim.beam_cfgs] == [-1.0, 1.0]
    lanes, _ = _beam_lanes(sim, 4000, 2, 13)
    NY, NX = sim.geom.slice_shape
    names = {"jx": "jx", "jy": "jy", "jz": "jz", "rhomjz": "rhomjz"}
    out = []
    for dev in ("cpu", cuda):
        zero = {v: torch.zeros((NY, NX), dtype=torch.float64, device=dev)
                for v in names.values()}
        charges = bm.beam_constants(sim.beam_cfgs, dev,
                                    torch.float64)["charges"]
        out.append(bm.deposit_beam_slice(
            {k: torch.as_tensor(v, device=dev) for k, v in lanes.items()},
            names, zero, sim.geom, sim.beam_cfgs, sim.pc, 2, True, charges))
    ref, got = out
    for k in ("jx", "jy", "jz"):
        assert _rel(got[k].cpu(), ref[k]) < 1e-12, k
    # rho - jz/c of a beam at gamma ~2000 is 1 - vz ~ 1e-6 of jz: one ulp
    # of a lane's vz is ~1e-10 of it, so that channel is held to 1e-12 of
    # the charge it carries (jz)
    err = float((got["rhomjz"].cpu() - ref["rhomjz"]).abs().max())
    assert err < 1e-12 * float(ref["jz"].abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ny,nx", [(255, 255), (63, 31), (96, 64), (32, 32)])
@pytest.mark.parametrize("acf_kind", ["plane", "plane+scalar"])
def test_complex_multigrid_kernel(cuda, dtype, ny, nx, acf_kind):
    """K3's complex path (the laser envelope's solve) against the plain
    version in both grid conventions: the plain version's V-cycle count and
    its values (measured bit-equal; held to 1e-12 / 1e-5)."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    rng = np.random.default_rng(ny * nx)
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    mg = MultiGrid(nx, ny, 0.3, 0.4, device=cuda, dtype=dtype)

    def c(scale=1.0):
        return torch.tensor(scale * (rng.standard_normal((ny, nx)) + 1j
                                     * rng.standard_normal((ny, nx))),
                            dtype=ctype, device=cuda)
    rhs, u0 = c(), c(0.1)
    acf_r = torch.tensor(20.0 + np.abs(rng.standard_normal((ny, nx))),
                         dtype=dtype, device=cuda)
    acf = (torch.complex(acf_r, torch.full_like(acf_r, -15.0))
           if acf_kind == "plane"
           else (acf_r, torch.tensor(-15j, dtype=ctype, device=cuda)))
    before = mg_solve.complex_launches
    got, cycles, _ = mg_solve(mg, u0, rhs, acf, tol_rel=1e-6)
    assert mg_solve.complex_launches == before + 1
    ref = mg.solve_plain(u0, rhs, acf, tol_rel=1e-6)
    torch.cuda.synchronize()
    assert got.dtype == ctype and int(cycles) == mg.last_cycles > 0
    assert _rel(got, ref) <= _tol(dtype, 1e-12, 1e-5)


def test_laser_steps_on_the_card_match_the_cpu(cuda):
    """Two 31^2 x 8 float64 steps of LASER_WAKE: fields and the envelope
    stream within 1e-8 of the CPU, equal real and complex V-cycles."""
    from hipace_tpu_torch.decks import laser_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sims = [Simulation(laser_wake(31, 8), device=dev, dtype=torch.float64,
                       verbose=0) for dev in ("cpu", cuda)]
    for step in range(2):
        ref, got = (s.advance(step, write_output=False) for s in sims)
        assert _rel(got["diag"].cpu(), ref["diag"]) < 1e-8
        assert _rel(got["laser_stream"][0].cpu(),
                    ref["laser_stream"][0]) < 1e-8
        assert got["mg_cycles"] == ref["mg_cycles"]
        assert got["laser_cycles"] == ref["laser_cycles"]


def test_adaptive_dt_on_the_card_matches_the_cpu(cuda):
    """ADAPTIVE_VACUUM at 16^2 x 16 in float64 through the time loop: the
    same dt sequence, landing on max_time, then a dt = 0 step."""
    from hipace_tpu_torch.decks import adaptive_vacuum
    from hipace_tpu_torch.pipeline.simulation import Simulation
    dts = []
    for dev in ("cpu", cuda):
        sim = Simulation(adaptive_vacuum(16, 16), device=dev,
                         dtype=torch.float64, verbose=0)
        seq = []
        for step in range(sim.max_step + 1):
            sim.set_dt()
            seq.append(sim.dt)
            sim.advance(step, write_output=False)
            if sim._has_last_step:
                break
        dts.append(seq)
        assert sim.time == 80.0
    assert len(dts[0]) == len(dts[1]) == 20 and dts[1][-1] == 0.0
    np.testing.assert_allclose(dts[1], dts[0], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ionization_module_on_the_card_matches_the_cpu(cuda, dtype):
    """IONIZATION_WAKE's ionization module on one slice's state: its K2
    field gather at the ions' x_prev against the plain gather, and the
    module on the card against the CPU with the same draws (equal levels
    and electron lanes, the electrons' values within the dtype's
    tolerance)."""
    from hipace_tpu_torch.decks import ionization_wake
    from hipace_tpu_torch.ops.gather import gather_main_cuda, gather_main_plain
    from hipace_tpu_torch.particles import plasma as pl
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(ionization_wake(48, 4), device="cpu", verbose=0)
    g, (ecfg, icfg) = sim.geom, sim.plasma_cfgs
    rng = np.random.default_rng(3)
    ion = pl.init_plasma(icfg, g, "cpu", torch.float64, normalized_units=False)
    n = ion["x"].numel()
    ion["x_prev"] = ion["x"] + torch.tensor(rng.uniform(-1e-7, 1e-7, n))
    elec = pl.pad_plasma(pl.init_plasma(ecfg, g, "cpu", torch.float64,
                                        normalized_units=False), n)
    NY, NX = g.slice_shape
    fields = {c: torch.tensor(rng.standard_normal((NY, NX)) * s) for c, s in (
        ("Psi", 2e4), ("Ez", 6e10), ("Bx", 60.), ("By", 60.), ("Bz", 5.))}
    draw = torch.tensor(rng.uniform(size=n))

    def on(dev, d):
        return {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev))
                for k, v in d.items()}

    args = (g, icfg, sim.pc, 2, False, 0.0, 0, -1)
    ref_ion, ref_e = pl.ionization_module(on("cpu", ion), on("cpu", elec),
                                          on("cpu", fields), *args,
                                          draw.to(dtype))
    got_ion, got_e = pl.ionization_module(on(cuda, ion), on(cuda, elec),
                                          on(cuda, fields), *args,
                                          draw.to(cuda, dtype))
    assert 0 < int(ref_e["valid"].sum()) < n
    assert torch.equal(got_ion["ion_lev"].cpu(), ref_ion["ion_lev"])
    assert torch.equal(got_e["valid"].cpu(), ref_e["valid"])
    for k in ("x", "y", "w", "x_prev"):
        assert _rel(got_e[k].cpu(), ref_e[k]) <= _tol(dtype, 1e-14, 1e-6)
    planes = pl.field_planes(on(cuda, fields))
    ym, xm = pl.cell_positions(on(cuda, ion)["x_prev"], on(cuda, ion)[
        "y_prev"], ion["valid"].to(cuda), g)
    got = gather_main_cuda(planes, ym, xm, 2)
    ref = gather_main_plain(planes, ym, xm, 2)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_collisions_on_the_card_match_the_cpu(cuda, dtype):
    """The same-species and the beam-plasma collision of one slice's state
    of COLLISION_WAKE, with the same draws, on the card against the CPU: in
    float64 within 1e-12; in float32, where their guards and products leave
    float32's range (ROADMAP R19), the same lanes non-finite and the finite
    values within 1e-5, so the card reproduces the CPU's float32 result."""
    from hipace_tpu_torch.decks import collision_wake
    from hipace_tpu_torch.particles import collisions as coll
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(collision_wake(31, 8, 1000), device="cpu", verbose=0)
    kept = {}
    orig = sim.slice_step.collide

    def keep(plasmas, emit, dt):
        if emit["x"].numel() > kept.get("nb", 0):
            kept.update(args=(plasmas, emit, dt), nb=emit["x"].numel())
        return orig(plasmas, emit, dt)

    sim.slice_step.collide = keep
    sim.run_step(0)
    plasmas, emit, dt = kept["args"]
    gen = torch.Generator().manual_seed(4)
    n, nb = plasmas[0]["x"].numel(), emit["x"].numel()
    dpp = {"sort": torch.rand(n, generator=gen, dtype=torch.float64),
           "kick": torch.rand((4, n), generator=gen, dtype=torch.float64),
           "wrap kick": torch.rand((4, n), generator=gen,
                                   dtype=torch.float64)}
    dbp = {"sort": dpp["sort"],
           "pick": torch.rand(nb, generator=gen, dtype=torch.float64),
           "kick": torch.rand((4, nb), generator=gen, dtype=torch.float64)}
    cfg = sim.cfg

    def run(dev):
        def on(d):
            return {k: (v.to(dev, dtype) if v.is_floating_point()
                        else v.to(dev)) for k, v in d.items()}
        q, _ = coll.plasma_plasma_collision(
            on(plasmas[0]), None, cfg.geom, cfg.plasmas[0], cfg.plasmas[0],
            cfg.pc, -1.0, cfg.background_density_SI, True, on(dpp), True)
        b, p = coll.beam_plasma_collision(
            on(emit), on(plasmas[0]), cfg.geom, cfg.beams[0], cfg.plasmas[0],
            cfg.pc, -1.0, cfg.background_density_SI, True, on(dbp), dt)
        return ([q[k] for k in ("ux", "uy", "psi")]
                + [b[k] for k in ("ux", "uy", "uz")]
                + [p[k] for k in ("ux", "uy", "psi")])

    for got, ref in zip(run(cuda), run("cpu")):
        got = got.cpu()
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(got), fin)
        if fin.any():
            assert _rel(got[fin], ref[fin]) <= _tol(dtype, 1e-12, 1e-5)


# ------------------------------------------------- SALAME, mesh refinement
@pytest.mark.parametrize("dtype", DTYPES)
def test_fine_level_lanes_far_outside(cuda, dtype):
    """K1 and K2 on a fine level's grid with the lanes of a whole species:
    most of them tens to hundreds of fine cells outside the grid on every
    side, some at rows >= 1.5 NY (dead to both kernels), some negative.
    Against the plain versions; every gathered value finite (a caller
    discards those lanes' values by a select, never a 0/1 product)."""
    from hipace_tpu_torch.ops.deposit import deposit_cuda, deposit_plain
    from hipace_tpu_torch.ops.gather import (gather_main_cuda,
                                             gather_main_plain)
    rng = np.random.default_rng(17)
    NY, NX, N = 67, 67, 60000
    ym = rng.uniform(-300.0, NY + 300.0, N)
    xm = rng.uniform(-300.0, NX + 300.0, N)
    ym[:5000] = rng.uniform(2.0, NY - 2.0, 5000)      # inside
    xm[:5000] = rng.uniform(2.0, NX - 2.0, 5000)
    ym[5000:6000] = 2.0 * NY                             # the dead row
    ym, xm = (torch.tensor(a, dtype=dtype, device=cuda) for a in (ym, xm))
    vals = torch.tensor(rng.standard_normal((13, N)), dtype=dtype,
                        device=cuda)
    zero = torch.zeros((13, NY, NX), dtype=dtype, device=cuda)
    got = deposit_cuda(zero.clone(), ym, xm, vals, 2, 2,
                       lattice_width=1023)
    ref = deposit_plain(zero.clone(), ym, xm, vals, 2, 2)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)
    planes = torch.tensor(rng.standard_normal((5, NY, NX)), dtype=dtype,
                          device=cuda)
    out = gather_main_cuda(planes, ym, xm, 2)
    want = gather_main_plain(planes, ym, xm, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _rel(out, want) < _tol(dtype, 1e-12, 1e-5)
    assert not out[:, 5000:6000].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_level_coupler_on_the_card(cuda, dtype):
    """A coupler's up_full and apply_bc in the card's matmuls (full float32:
    no TF32) against the CPU's in float64."""
    from hipace_tpu_torch.decks import mr_wake
    from hipace_tpu_torch.fields.mr import LevelCoupler, parse_mr_levels
    from hipace_tpu_torch.geometry import Geometry
    assert not torch.backends.cuda.matmul.allow_tf32
    inputs = mr_wake(255, 16, 1000, 127)
    g0 = Geometry.from_inputs(inputs)
    fg = parse_mr_levels(inputs, g0)[0].geom
    rng = np.random.default_rng(18)
    c = rng.standard_normal(g0.slice_shape)
    rhs = rng.standard_normal((fg.ny, fg.nx))
    ref = LevelCoupler(g0, fg, torch.float64, "cpu")
    got = LevelCoupler(g0, fg, dtype, cuda)
    tc = torch.tensor(c, dtype=dtype, device=cuda)
    tol = _tol(dtype, 1e-12, 1e-6)
    assert _rel(got.up_full(tc).cpu().double(),
                ref.up_full(torch.tensor(c))) < tol
    for off, fac in ((1.0, 1.0), (0.5, 8.0 / 3.0)):
        assert _rel(got.apply_bc(torch.tensor(rhs, dtype=dtype, device=cuda),
                                 tc, off, fac).cpu().double(),
                    ref.apply_bc(torch.tensor(rhs), torch.tensor(c), off,
                                 fac)) < tol


def test_salame_slice_on_the_card(cuda):
    """One salame_slice of a 32^2 x 64 SALAME_WAKE step on the card against
    the same call on the CPU, in float64: the fields it writes, the new
    weights, the state, and the V-cycles of its eight solves."""
    from hipace_tpu_torch.decks import salame_wake
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.fields.poisson import make_poisson_solver
    from hipace_tpu_torch.pipeline import step as stp
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(salame_wake(32, 64, 30000), device="cpu", verbose=0)
    kept, orig = [], stp.salame_slice

    def keep(*args):
        if not kept:
            kept.append(args)
        return orig(*args)

    stp.salame_slice = keep
    try:
        sim.run_step(0)
    finally:
        stp.salame_slice = orig
    (cfg, this, f_next, f_prev, plasmas, dgrids, beam, state, islice, _, _,
     target, charges) = kept[0]

    def on(x):
        if torch.is_tensor(x):
            return x.to(cuda)
        if isinstance(x, dict):
            return {k: on(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(on(v) for v in x)
        return x

    g = cfg.geom
    ref = orig(cfg, this, f_next, f_prev, plasmas, dgrids, beam, state,
               islice, make_poisson_solver(cfg.poisson_solver, g, "cpu",
                                           torch.float64),
               MultiGrid(g.nx, g.ny, g.dx, g.dy, device="cpu",
                         dtype=torch.float64), target, charges)
    got = orig(cfg, on(this), on(f_next), on(f_prev), on(plasmas),
               on(dgrids), on(beam), on(state), islice,
               make_poisson_solver(cfg.poisson_solver, g, cuda,
                                   torch.float64),
               MultiGrid(g.nx, g.ny, g.dx, g.dy, device=cuda,
                         dtype=torch.float64), target, on(charges))
    torch.cuda.synchronize()
    for c in ("Bx", "By", "Sx", "Sy", "jz_beam"):
        assert _rel(got[0][c].cpu(), ref[0][c]) < 1e-9, c
    assert _rel(got[1]["w"].cpu(), ref[1]["w"]) < 1e-12
    for k in ("W_last", "dbg", "ez_target", "zeta_initial"):
        assert _rel(got[2][k].cpu(), ref[2][k]) < 1e-9, k
    assert [int(c) for c in got[3]] == [int(c) for c in ref[3]]


@pytest.mark.parametrize("deck_name", ["ionization", "collision"])
def test_mr_step_with_draws_on_the_card(cuda, deck_name):
    """A 32^2 x 16 float64 step with a mesh-refinement level and a fine
    plasma patch, with field ionization or collisions, on the card against
    the CPU from the same beam and the CPU's recorded slice draws: both
    levels' fields within 1e-8."""
    from hipace_tpu_torch import decks
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.parser import Inputs
    from hipace_tpu_torch.pipeline.simulation import Simulation
    if deck_name == "ionization":
        text = decks.IONIZATION_WAKE.format(nxy=32, nz=16) + (
            "amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
            "mr_lev1.patch_lo = -6.e-6 -6.e-6 -10.e-6\n"
            "mr_lev1.patch_hi = 6.e-6 6.e-6 20.e-6\n"
            "ion.fine_patch(x,y) = (abs(x)<7.e-6)*(abs(y)<7.e-6)\n"
            "ion.fine_ppc = 2 2\n")
    else:
        text = decks.COLLISION_WAKE.format(nxy=32, nz=16, npart=2000) + (
            "amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
            "mr_lev1.patch_lo = -2. -2. -4.\nmr_lev1.patch_hi = 2. 2. 0.\n"
            "plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)\n"
            "plasma.fine_ppc = 2 2\n")
    text += ("diagnostic.names = lev0 lev1\nlev1.base_geometry = level_1\n"
             "lev1.field_data = all\nlev1.output_period = 1\n"
             "hipace.openpmd_backend = json\n")
    cpu = Simulation(Inputs(text), device="cpu", verbose=0)
    gpu = Simulation(Inputs(text), device=cuda, dtype=torch.float64,
                     verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time,
                [b.total_charge for b in cpu.beam_cfgs])
    drawn, own = [], cpu.slice_step.draws

    def record(name, *shape):
        drawn.append(own(name, *shape))
        return drawn[-1]

    cpu.slice_step.draws = record
    ref = cpu.run_step(0)
    gpu.slice_step.draws = lambda name, *shape: drawn.pop(0).to(cuda)
    got = gpu.run_step(0)
    assert not drawn
    lv = gpu.mr_levels[0]
    rows = slice(lv.zeta_lo, lv.zeta_hi + 1)
    assert _rel(got["diag"].cpu(), ref["diag"]) < 1e-8
    assert _rel(got["diagf_lev1"][rows].cpu(), ref["diagf_lev1"][rows]) < 1e-8


def test_pipelined_window_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """evolve_pipelined with two stages on one card in float64, a 32^2 x 16
    flagship from the CPU run's beam: every stage's fields within 1e-8 of
    the same two stages on the CPU, equal V-cycles on every slice of every
    stage, the beam after the window within 1e-8."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.parallel import pipeline as pp
    from hipace_tpu_torch.pipeline.simulation import Simulation
    wins, window = [], pp.pipelined_window
    monkeypatch.setattr(pp, "pipelined_window",
                        lambda *a, **k: wins.append(window(*a, **k))
                        or wins[-1])
    sims = []
    for dev in ("cpu", cuda):
        sim = Simulation(blowout_wake(32, 16, 2000, "max_step = 1\n"),
                         device=dev, dtype=torch.float64, verbose=0)
        if sims:
            cpu = sims[0]
            carry_state(sim, {k: v.numpy() for k, v in cpu.binned0.items()
                              if torch.is_tensor(v)}, cpu.dt, 0.0)
        sim.binned0 = sim.binned
        sim.evolve_pipelined(devices=[torch.device(dev)] * 2,
                             write_output=False)
        sims.append(sim)
    assert len(wins) == 2
    for ref, got in zip(*(w["stages"] for w in wins)):
        assert _rel(got["diag"].cpu(), ref["diag"]) < 1e-8
        assert got["mg_cycles"] == ref["mg_cycles"]
    ref, got = sims[0].binned, sims[1].binned
    v = ref["valid"]
    assert torch.equal(got["valid"].cpu(), v) and int(v.sum()) > 1900
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        assert _rel(got[k].cpu()[v], ref[k][v]) < 1e-8, k


def test_pipelined_window_on_distinct_cards_matches_one_card(cuda):
    """Two stages on cuda:0 and cuda:1 against the same two stages sharing
    cuda:0, in float64 on a 32^2 x 16 flagship
    from one beam: every stage's fields within 1e-8, equal V-cycles, the
    beam after the window within 1e-8. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.parallel import pipeline as pp
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(blowout_wake(32, 16, 2000, "max_step = 1\n"),
                     device="cuda:0", dtype=torch.float64, verbose=0)
    wins = [pp.pipelined_window(sim, sim.binned, [sim.dt] * 2,
                                [0.0, sim.dt], 0,
                                [torch.device(f"cuda:{i}") for i in ids])
            for ids in ((0, 0), (0, 1))]
    for ref, got in zip(*(w["stages"] for w in wins)):
        assert _rel(got["diag"].cpu(), ref["diag"].cpu()) < 1e-8
        assert got["mg_cycles"] == ref["mg_cycles"]
    ref, got = (w["beam"] for w in wins)
    v = ref["valid"].cpu()
    assert torch.equal(got["valid"].cpu(), v) and int(v.sum()) > 1900
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        assert _rel(got[k].cpu()[v], ref[k].cpu()[v]) < 1e-8, k


def test_bench_on_the_card_names_it(cuda):
    """The bench at 255^2 x 16 on the card: its record names the card, the
    kernels ran on every slice, and the runs are listed."""
    import io

    from hipace_tpu_torch import bench
    rec = bench.run(nxy=255, nz=16, steps=3, runs=2, log=io.StringIO())
    assert rec["device"] == torch.cuda.get_device_name(0) != "cpu"
    assert len(rec["runs"]) == 2 and rec["value"] > 0
    assert rec["peak_gib"] > 0
    assert all(rec["launches_per_slice"][k] >= 1 for k in ("K1", "K2", "K3"))


def test_gate_case_passes(cuda):
    """The first case of the gate's small ladder: card float64 within 1e-8
    of the CPU, card float32 within its pinned tolerance of float64."""
    from hipace_tpu_torch import gpu_check as gc
    entry = gc.run_case(gc.CASES[0])
    assert entry["f64_vs_cpu"]["ok"] and entry["f32_vs_f64"]["ok"], entry
