"""The fused plasma push (``csrc/plasma_push.cu``) against its plain version
(``ops/plasma_push.py`` ``plasma_push_plain``) on a GPU.

Marked ``gpu``: they build the kernels with nvcc and need a CUDA device, so
they skip on a CPU-only machine. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_plasma_push.py

The kernel rounds every step of the push as the loop's PyTorch ops do, in
their order, its field gather is K2's code and its |a|^2 gather sums in the
order of PyTorch's CUDA sum, so the two are held equal bit for bit, in
float64 and float32.
"""

import numpy as np
import pytest
import torch

from test_torch_plasma_push import (BOUNDARIES, GEOM, UNITS, VARIANTS,
                                    push_case, push_cfg)

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(d, device, dtype):
    out = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in out.items()}


def _same(got, ref, what):
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (what, k)
        assert torch.equal(got[k], ref[k]), (what, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_plasma_push_kernel(cuda, dtype, boundary, order):
    """Every variant of the CPU tests (laser, ion levels, the trial push,
    one and two subcycles, c = 1 and 1.7) on lattice lanes, dead lanes at
    the sentinel and lanes across the box's edges: the kernel equals the
    loop on the card."""
    from hipace_tpu_torch.ops import plasma_push as pp_ops
    lanes, fields = push_case(10 * order + len(boundary))
    for use_laser, ion, temp, nsub, units in VARIANTS:
        what = (use_laser, ion, temp, nsub, units)
        pc = UNITS[units][0]
        cfg = push_cfg(units, boundary, nsub, ion)
        p, f = _on(lanes, cuda, dtype), _on(fields, cuda, dtype)
        got = pp_ops.plasma_push_cuda(p, f, GEOM, cfg, pc, order, temp,
                                      use_laser)
        ref = pp_ops.plasma_push_plain(p, f, GEOM, cfg, pc, order, temp,
                                       use_laser=use_laser)
        torch.cuda.synchronize()
        _same(got, ref, what)
        if not temp:
            assert got["x_prev"] is got["x"], what
        if boundary != "Absorbing":
            assert got["w"] is p["w"] and got["valid"] is p["valid"], what


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_laser_gather_device_function(cuda, dtype, order):
    """The push's inline |a|^2 gather against gather_laser_aabs on the card,
    with lanes past every edge of the plane."""
    from hipace_tpu_torch.ops.gather import gather_laser_aabs
    from hipace_tpu_torch.ops.plasma_push import laser_gather_cuda
    rng = np.random.default_rng(order)
    n = 20000
    g = GEOM
    xp = rng.uniform(g.prob_lo[0] - 2.0, g.prob_hi[0] + 2.0, n)
    yp = rng.uniform(g.prob_lo[1] - 2.0, g.prob_hi[1] + 2.0, n)
    aabs = 3.0 * rng.random(g.slice_shape)
    xp, yp, aabs = (torch.tensor(a, dtype=dtype, device=cuda)
                    for a in (xp, yp, aabs))
    got = laser_gather_cuda(xp, yp, aabs, g, order)
    ref = gather_laser_aabs(xp, yp, aabs, g, order)
    torch.cuda.synchronize()
    for a, b, name in zip(got, ref, ("a2", "a2_dx", "a2_dy")):
        assert torch.equal(a, b), name


def test_plasma_push_kernel_at_full_width_with_the_laser(cuda):
    """laser.2047's species: 4,190,209 lanes of the 2047^2 lattice in
    float64, moved and with momenta, through the laser path."""
    from hipace_tpu_torch.constants import NORMALIZED
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops import plasma_push as pp_ops
    from hipace_tpu_torch.particles import plasma as tpl
    g = Geometry((2047, 2047, 40), (-20.0, -20.0, -7.5), (20.0, 20.0, 6.0))
    cfg = tpl.PlasmaConfig()
    p = tpl.init_plasma(cfg, g, cuda, torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(7)

    def noise(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=cuda,
                                   dtype=torch.float64)

    n = p["x"].numel()
    x, y = p["x"] + noise(n, 0.01), p["y"] + noise(n, 0.01)
    p.update(x=x, y=y, x_prev=x, y_prev=y, ux_half=noise(n, 0.2),
             uy_half=noise(n, 0.2), psi_half=1.0 + noise(n, 0.05).abs())
    NY, NX = g.slice_shape
    f = {c: noise((NY, NX), 0.1) for c in ("Psi", "Ez", "Bx", "By", "Bz")}
    f["aabs"] = 4.0 * torch.rand((NY, NX), generator=gen, device=cuda,
                                 dtype=torch.float64)
    got = pp_ops.plasma_push_cuda(p, f, g, cfg, NORMALIZED, 2, False, True)
    ref = pp_ops.plasma_push_plain(p, f, g, cfg, NORMALIZED, 2,
                                   use_laser=True)
    torch.cuda.synchronize()
    assert n == 4_190_209
    _same(got, ref, "2047^2")


def _run_counted(sim, steps):
    """Run steps of sim; (kernel launches, loop pushes on the card, the
    slices and the predictor-corrector's iterations swept)."""
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.particles.plasma import advance_plasma
    before = (plasma_push.launches, advance_plasma.general_calls)
    slices = iters = 0
    for step in range(steps):
        res = sim.advance(step, write_output=False)
        slices += len(res["mg_cycles"])
        iters += sum(res["pc_iters"])
    torch.cuda.synchronize()
    return (plasma_push.launches - before[0],
            advance_plasma.general_calls - before[1], slices, iters)


@pytest.mark.parametrize("case", ["explicit", "laser", "pc", "ab5"])
def test_plasma_push_counts_launches(cuda, case):
    """Two short steps of each cell's deck (explicit.2047's PDF_BEAM deck,
    laser.2047's LASER_WAKE deck) and of the predictor-corrector: one
    launch per species and slice, and per species and iteration of the
    trial push; the AB5 pusher keeps the loop, one push per species and
    slice."""
    from hipace_tpu_torch.decks import (ion_motion_even, laser_wake,
                                        pc_open, pdf_beam)
    from hipace_tpu_torch.pipeline.simulation import Simulation
    deck = {"explicit": lambda: pdf_beam(63, 8, 2000),
            "laser": lambda: laser_wake(63, 8),
            "pc": lambda: pc_open(63, 8, 2000),
            "ab5": lambda: ion_motion_even(
                64, 8, 2000, "hipace.plasma_pusher = ab5\n")}[case]()
    sim = Simulation(deck, device=cuda, dtype=torch.float64, verbose=0)
    species = len(sim.plasma_cfgs)
    launches, loops, slices, iters = _run_counted(sim, 2)
    assert slices == 2 * sim.geom.nz
    if case == "ab5":
        assert (launches, loops) == (0, species * slices)
    else:
        assert (launches, loops) == (species * (slices + iters), 0)
    if case == "pc":
        assert iters > slices


def test_an_active_fine_level_keeps_the_loop(cuda):
    """On the card a push with an active fine level, or by the AB5 pusher,
    runs the loop and counts in advance_plasma.general_calls; a level
    tuple of Nones takes the kernel."""
    from hipace_tpu_torch.constants import NORMALIZED
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.particles import plasma as tpl
    lanes, fields = push_case(9)
    p, f = _on(lanes, cuda, torch.float64), _on(fields, cuda, torch.float64)
    cfg = push_cfg("normalized", "Periodic", 1, False)
    tag = torch.ones(p["x"].numel(), dtype=torch.int32, device=cuda)
    before = (plasma_push.launches, tpl.advance_plasma.general_calls)
    tpl.advance_plasma(p, f, GEOM, cfg, NORMALIZED, fine_levels=((f, GEOM),),
                       tag=tag)
    tpl.advance_plasma(p, f, GEOM, cfg, NORMALIZED, fine_levels=(None,),
                       tag=tag)
    ab5 = tpl.init_plasma(cfg, GEOM, cuda, torch.float64, ab5=True)
    tpl.advance_plasma(ab5, f, GEOM, cfg, NORMALIZED, pusher="ab5")
    torch.cuda.synchronize()
    assert (plasma_push.launches, tpl.advance_plasma.general_calls) == (
        before[0] + 1, before[1] + 2)


def test_plasma_push_rejects_what_it_does_not_take(cuda):
    """A lane attribute on the CPU, an |a|^2 plane of another shape, an
    order or subcycle count the kernel has no code for: each raises before
    any launch."""
    from hipace_tpu_torch.constants import NORMALIZED
    from hipace_tpu_torch.ops import plasma_push as pp_ops
    lanes, fields = push_case(11)
    cfg = push_cfg("normalized", "Periodic", 1, False)
    before = pp_ops.plasma_push.launches
    bad = [
        (dict(_on(lanes, cuda, torch.float64), w=torch.as_tensor(lanes["w"])),
         _on(fields, cuda, torch.float64), cfg, 2),
        (_on(lanes, cuda, torch.float64),
         dict(_on(fields, cuda, torch.float64),
              aabs=torch.zeros((4, 4), dtype=torch.float64, device=cuda)),
         cfg, 2),
        (_on(lanes, cuda, torch.float64), _on(fields, cuda, torch.float64),
         cfg, 4),
        (_on(lanes, cuda, torch.float64), _on(fields, cuda, torch.float64),
         push_cfg("normalized", "Periodic", 0, False), 2),
    ]
    for p, f, c, order in bad:
        with pytest.raises(ValueError):
            pp_ops.plasma_push_cuda(p, f, GEOM, c, NORMALIZED, order,
                                    use_laser=True)
    assert pp_ops.plasma_push.launches == before
