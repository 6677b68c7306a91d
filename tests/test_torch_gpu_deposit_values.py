"""The plasma deposit's values kernel (``csrc/deposit_values.cu``) against its
plain version (``ops/deposit_values.py`` ``deposit_values_plain``) on a GPU.

Marked ``gpu``: they build the kernels with nvcc and need a CUDA device, so
they skip on a CPU-only machine. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_deposit_values.py

The kernel rounds every step of the lane algebra as the plain version's
PyTorch ops do, in their order, and its |a|^2 gather sums in the order of
PyTorch's CUDA sum, so the value rows, the cell positions, w and valid are
held equal bit for bit, in float64 and float32. K1 then deposits equal
inputs; its sums of a cell's contributions from several blocks may meet in
either order, so the deposited stacks are held to K1's own tolerance.
"""

import pytest
import torch

from test_torch_deposit_values import (COMPS, ORDER_TYPES, VARIANTS, _call,
                                       _deposits_before, values_case)

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
# K1's tolerance on max|a - b| / max|b| (chip_smoke.py TOL["K1"])
K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(d, device, dtype):
    out = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in out.items()}


def _args(lanes, f0, f1, mask, variant, order, device, dtype):
    """One variant's deposit_values arguments on the card."""
    (p, comps, fields, geom, cfg, pc, normalized), kw = _call(
        lanes, f0, f1, mask, variant)
    p = _on({k: v.numpy() for k, v in p.items()}, device, dtype)
    fields = _on({k: v.numpy() for k, v in fields.items()}, device, dtype)
    if "extra_mask" in kw:
        kw["extra_mask"] = kw["extra_mask"].to(device)
    return (p, comps, fields, geom, cfg, pc, order, normalized), kw


def _close(a, b, dtype, what):
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    assert err <= K1_TOL[dtype] * max(scale, 1e-300), (what, err, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order, deriv_type", ORDER_TYPES)
def test_deposit_values_kernel(cuda, dtype, order, deriv_type):
    """Every variant of the CPU tests (laser, ion levels, a fine level with
    its mask, c = 1 and 1.7, four and seven main channels) on lanes that
    fail the quasi-static test, dead lanes and lanes past the box: the
    kernel's rows, positions, w and valid equal the plain version's on the
    card."""
    from hipace_tpu_torch.ops import deposit_values as dv_ops
    lanes, f0, f1, mask = values_case(10 * order + deriv_type)
    for variant in VARIANTS:
        args, kw = _args(lanes, f0, f1, mask, variant, order, cuda, dtype)
        got = dv_ops.deposit_values_cuda(*args, deriv_type=deriv_type, **kw)
        ref = dv_ops.deposit_values_plain(*args, deriv_type=deriv_type,
                                          **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("rows", "ym", "xm", "w", "valid"), got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, (variant, name)
            assert torch.equal(a, b), (variant, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deposits_take_the_kernel(cuda, dtype):
    """fused_plasma_deposits on the card (one launch of the values kernel)
    against the function as it stood before its lane algebra moved (the
    lane algebra in PyTorch's ops, then K1): its new w and valid are equal
    and K1's stack and derivative grids agree within K1's tolerance."""
    from hipace_tpu_torch.ops import deposit_values as dv_ops
    from hipace_tpu_torch.particles import plasma as tpl
    lanes, f0, f1, mask = values_case(21)
    for variant in [v for v in VARIANTS if v[3] == "c 1.7"]:
        args, kw = _args(lanes, f0, f1, mask, variant, 2, cuda, dtype)
        before = dv_ops.deposit_values.launches
        got = tpl.fused_plasma_deposits(*args, **kw)
        ref = _deposits_before(*args, **kw)
        torch.cuda.synchronize()
        assert dv_ops.deposit_values.launches == before + 1, variant
        assert torch.equal(got[1]["w"], ref[1]["w"]), variant
        assert torch.equal(got[1]["valid"], ref[1]["valid"]), variant
        for c in args[1]:
            _close(got[0][c], ref[0][c], dtype, (variant, c))
        for a, b in zip(got[2][:3], ref[2][:3]):
            _close(a, b, dtype, variant)


def test_deposit_values_at_full_width_with_the_laser(cuda):
    """laser.2047's species: 4,190,209 lanes of the 2047^2 lattice in
    float64, moved and with momenta, with laser.2047's channels."""
    from hipace_tpu_torch.constants import NORMALIZED
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops import deposit_values as dv_ops
    from hipace_tpu_torch.particles import plasma as tpl
    g = Geometry((2047, 2047, 40), (-20.0, -20.0, -7.5), (20.0, 20.0, 6.0))
    cfg = tpl.PlasmaConfig()
    p = tpl.init_plasma(cfg, g, cuda, torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(8)

    def noise(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=cuda,
                                   dtype=torch.float64)

    n = p["x"].numel()
    p.update(x=p["x"] + noise(n, 0.01), y=p["y"] + noise(n, 0.01),
             ux=noise(n, 0.2), uy=noise(n, 0.2),
             psi=1.0 + noise(n, 0.05).abs())
    NY, NX = g.slice_shape
    f = {"aabs": 4.0 * torch.rand((NY, NX), generator=gen, device=cuda,
                                  dtype=torch.float64)}
    args = (p, COMPS["four"], f, g, cfg, NORMALIZED, 2, True)
    got = dv_ops.deposit_values_cuda(*args, use_laser=True)
    ref = dv_ops.deposit_values_plain(*args, use_laser=True)
    torch.cuda.synchronize()
    assert n == 4_190_209 and got[0].shape == (14, n)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _run_counted(sim, steps):
    """Run steps of sim; (kernel launches, the slices swept)."""
    from hipace_tpu_torch.ops.deposit_values import deposit_values
    before = deposit_values.launches
    slices = 0
    for step in range(steps):
        res = sim.advance(step, write_output=False)
        slices += len(res["mg_cycles"])
    torch.cuda.synchronize()
    return deposit_values.launches - before, slices


@pytest.mark.parametrize("case", ["explicit", "laser", "mr"])
def test_deposit_values_count_launches(cuda, case):
    """Two short steps of each cell's deck (explicit.2047's PDF_BEAM deck,
    laser.2047's LASER_WAKE deck) and of MR_WAKE: one launch per species
    and slice on level 0, one more per species on each slice where the fine
    level is active."""
    from hipace_tpu_torch.decks import laser_wake, mr_wake, pdf_beam
    from hipace_tpu_torch.pipeline.simulation import Simulation
    deck = {"explicit": lambda: pdf_beam(63, 8, 2000),
            "laser": lambda: laser_wake(63, 8),
            "mr": lambda: mr_wake(63, 16, 2000, 31)}[case]()
    sim = Simulation(deck, device=cuda, dtype=torch.float64, verbose=0)
    species = len(sim.plasma_cfgs)
    fine = 0
    for lv in sim.mr_levels:
        fine += lv.zeta_hi - lv.zeta_lo + 1
    assert (case == "mr") == (fine > 0)
    launches, slices = _run_counted(sim, 2)
    assert slices == 2 * sim.geom.nz
    assert launches == species * (slices + 2 * fine)


def test_deposit_values_rejects_what_it_does_not_take(cuda):
    """A lane attribute on the CPU or of another dtype, an ion level or a
    mask of the wrong type or shape, an |a|^2 plane of another dtype, an
    order the kernel has no code for: each raises before any launch."""
    from hipace_tpu_torch.ops import deposit_values as dv_ops
    lanes, f0, f1, mask = values_case(11)
    dt = torch.float64
    ok, kw = _args(lanes, f0, f1, mask, (True, True, True, "normalized",
                                         "four"), 2, cuda, dt)
    p, comps, fields, geom, cfg, pc, order, normalized = ok
    bad = [
        (dict(p, w=p["w"].cpu()), fields, kw, order),
        (dict(p, psi=p["psi"].float()), fields, kw, order),
        (dict(p, x=p["x"][:-1]), fields, kw, order),
        (dict(p, ion_lev=p["ion_lev"].long()), fields, kw, order),
        (p, fields, dict(kw, extra_mask=kw["extra_mask"][:-1]), order),
        (p, fields, dict(kw, extra_mask=kw["extra_mask"].int()), order),
        (p, dict(fields, aabs=fields["aabs"].float()), kw, order),
        (p, fields, kw, 4),
    ]
    before = dv_ops.deposit_values.launches
    for q, f, k, o in bad:
        with pytest.raises(ValueError):
            dv_ops.deposit_values_cuda(q, comps, f, geom, cfg, pc, o,
                                       normalized, **k)
    assert dv_ops.deposit_values.launches == before
    got = dv_ops.deposit_values_cuda(p, comps, fields, geom, cfg, pc, order,
                                     normalized, **kw)
    assert dv_ops.deposit_values.launches == before + 1
    assert got[0].shape[0] == len(dv_ops.value_codes(comps, 2, True))
