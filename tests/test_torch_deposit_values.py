"""The plasma deposit's values (``ops/deposit_values.py``): the choice
between the kernel and the plain lane algebra, and the plain algebra itself,
on the CPU in float64.

A species' explicit deposit on a slice takes the values kernel on the card
(orders 0-3, derivative types 0-2, as K1); on the CPU every call runs
``deposit_values_plain``, which is also the kernel's plain version.
Here ``fused_plasma_deposits`` is held bit for bit to itself as it stood
before its lane algebra moved (``_deposits_before``), on lattice lanes moved
about the box, some dead, some with psi < 0 or gamma past
``max_qsa_weighting_factor``, some past the box's edges, with and without
the laser, ionizing and not, on level 0 and on a fine level (``extra_mask``,
``geom0``), for derivative types 0-2, orders 0-3, in normalized units and
with c = 1.7. The rows' value codes, the kernel's scalars and the counters
(which count only on the card) are checked too.
"""

import numpy as np
import pytest
import torch

from hipace_tpu_torch.constants import NORMALIZED, PhysConst
from hipace_tpu_torch.decks import laser_wake, mr_wake, pdf_beam
from hipace_tpu_torch.geometry import Geometry
from hipace_tpu_torch.ops import cuda_lib
from hipace_tpu_torch.ops import deposit_values as dv_ops
from hipace_tpu_torch.ops.deposit import deposit, deposit_plain
from hipace_tpu_torch.ops.gather import gather_laser_aabs
from hipace_tpu_torch.ops.shape import DW_KIND, W_KIND
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
GEOM = Geometry((23, 21, 8), (-4.0, -3.5, -3.0), (4.0, 3.5, 1.0))
# a fine level inside GEOM, at about twice its resolution
FINE = Geometry((27, 25, 8), (-2.2, -1.9, -3.0), (2.2, 1.9, 1.0))
# units in which c is not 1, so that 1/c and 1/c^2 round
C17 = PhysConst(c=1.7, ep0=1.0, mu0=1.3, q_e=1.0, m_e=1.0, m_p=1836.0)
UNITS = {"normalized": (NORMALIZED, 1.0, True), "c 1.7": (C17, 1.3, False)}
COMPS = {"four": ["jx", "jy", "chi", "rhomjz"],
         "every": ["jx", "jy", "rho", "chi", "rhomjz", "jz", "rho_plasma"]}


def _deposits_before(p, stack_comps, fields, geom, cfg, pc, order,
                     normalized_units, deriv_type=2, use_laser=False,
                     extra_mask=None, geom0=None):
    """fused_plasma_deposits as it stood before its lane algebra moved to
    ops/deposit_values.py."""
    charge = cfg.charge
    cin = 1.0 / pc.c
    invvol = tpl.deposit_invvol(geom, geom0, normalized_units)
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv
    vy_c = p["uy"] * psi_inv
    vx = vx_c * cin
    vy = vy_c * cin
    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    q_m = charge / cfg.mass
    lnorm = tpl.laser_norm(cfg, pc)
    if cfg.can_ionize:
        ion = p["ion_lev"].to(psi_inv.dtype)
        q_invvol = q_invvol * ion
        q_mu0_m = q_mu0_m * ion
        q_m = q_m * ion
        lnorm = lnorm * ion * ion
    if use_laser:
        a2 = gather_laser_aabs(p["x"], p["y"], fields["aabs"], geom,
                               order)[0] * lnorm
        gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                           + vx * vx + vy * vy + 1.0)
    else:
        gamma_psi = 0.5 * (psi_inv * psi_inv + vx * vx + vy * vy + 1.0)
    wmask, bad = tpl._qsa_mask(p, gamma_psi, psi_inv, cfg)
    q_invvol = q_invvol * (wmask if extra_mask is None else wmask
                           * extra_mask.to(wmask.dtype))
    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * pc.c,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }
    cd_mu0 = charge * invvol * pc.mu0 * p["w"] * (
        wmask if extra_mask is None
        else (p["valid"] & extra_mask).to(wmask.dtype))
    if cfg.can_ionize:
        cd_mu0 = cd_mu0 * ion
    qm_psi = q_m * psi_inv
    base = cd_mu0 * qm_psi
    chans = [base * vx, base * vy, base * vx * vy * cin,
             base * (gamma_psi - vy * vy) * cin,
             base * (gamma_psi - vx * vx) * cin]
    if use_laser:
        chans.append(0.25 * base * qm_psi)
    cdc = cd_mu0 * pc.c
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    v2 = [cdc * dx_inv * vx * vy,
          cdc * dx_inv * (gamma_psi - vx * vx - 1.0)]
    v3 = [-cdc * dy_inv * (gamma_psi - vy * vy - 1.0),
          -cdc * dy_inv * vx * vy]
    vmain = [values["rho" if c.startswith("rho_") else c]
             for c in stack_comps] + chans
    Cm, C1 = len(stack_comps), len(chans)
    acc = torch.cat([torch.stack([fields[c] for c in stack_comps]),
                     torch.zeros((C1 + 4,) + geom.slice_shape,
                                 dtype=psi_inv.dtype,
                                 device=psi_inv.device)])
    mask = p["valid"] if extra_mask is None else p["valid"] & extra_mask
    ym, xm = tpl.cell_positions(p["x"], p["y"], mask, geom)
    lattice = (geom0 if geom0 is not None else geom).nx
    if deriv_type == 2:
        deposit(acc, ym, xm, torch.stack(vmain + v2 + v3), order,
                deriv_type=2, lattice_width=lattice)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1:Cm + C1 + 2],
                  acc[Cm + C1 + 2:], True)
    else:
        deposit(acc, ym, xm, torch.stack(vmain + v3 + v2), order,
                deriv_type=deriv_type,
                blocks=((W_KIND, W_KIND, Cm + C1), (DW_KIND, W_KIND, 2),
                        (W_KIND, DW_KIND, 2)), lattice_width=lattice)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1 + 2:],
                  acc[Cm + C1:Cm + C1 + 2], False)
    out = dict(fields)
    out.update(zip(stack_comps, acc[:Cm]))
    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out, new_p, dgrids


def values_case(seed, geom=GEOM, fine=FINE):
    """(lanes, level-0 fields, fine-level fields, the fine level's mask) as
    numpy float64 / bool / int32: a species' lattice lanes of geom moved by
    up to half a cell, every 13th dead, a tenth past the box's edges, some
    with psi < 0 and some with momenta that put gamma past the quasi-static
    limit, ion levels 0-3; each level's slice with every deposit channel,
    the five planes and an |a|^2 plane; the mask a random half of the
    lanes."""
    rng = np.random.default_rng(seed)
    iy, ix = np.meshgrid(np.arange(geom.ny), np.arange(geom.nx),
                         indexing="ij")
    jit = rng.uniform(-0.5, 0.5, (2, ix.size))
    x = geom.prob_lo[0] + (ix.ravel() + 0.5 + jit[0]) * geom.dx
    y = geom.prob_lo[1] + (iy.ravel() + 0.5 + jit[1]) * geom.dy
    n = x.size
    edge = rng.random(n) < 0.1
    x[edge] += rng.choice([-1.0, 1.0], int(edge.sum())) * 4.5
    ux = 0.3 * rng.standard_normal(n)
    uy = 0.3 * rng.standard_normal(n)
    hot = rng.random(n) < 0.08
    ux[hot] = 12.0 * rng.standard_normal(int(hot.sum()))
    psi = 1.0 + 0.2 * rng.random(n)
    psi[rng.random(n) < 0.05] *= -1.0
    valid = np.ones(n, bool)
    valid[::13] = False
    lanes = {"x": x, "y": y, "ux": ux, "uy": uy, "psi": psi,
             "w": rng.uniform(0.5, 1.5, n) * valid, "valid": valid,
             "ion_lev": rng.integers(0, 4, n).astype(np.int32)}

    def slice_fields(g):
        NY, NX = g.slice_shape
        return {c: 0.1 * rng.standard_normal((NY, NX))
                for c in ("Psi", "Ez", "Bx", "By", "Bz", "aabs", "jx", "jy",
                          "jz", "rho", "chi", "rhomjz", "rho_plasma")}

    return lanes, slice_fields(geom), slice_fields(fine), rng.random(n) < 0.5


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _same(got, ref, what):
    """Two fused_plasma_deposits results equal bit for bit."""
    (gf, gp, gd), (rf, rp, rd) = got, ref
    for a, b in ((gf, rf), (gp, rp)):
        assert a.keys() == b.keys(), what
        for k in b:
            assert a[k].dtype == b[k].dtype, (what, k)
            assert torch.equal(a[k], b[k]), (what, k)
    assert gd[3] == rd[3], what
    for a, b in zip(gd[:3], rd[:3]):
        assert torch.equal(a, b), what


# (use_laser, ionizing, fine level, units, comps) of every call
VARIANTS = [(laser, ion, fine, units, comps)
            for laser in (False, True) for ion in (False, True)
            for fine in (False, True) for units in UNITS for comps in COMPS]


def _call(lanes, f0, f1, mask, variant):
    """The arguments of one fused_plasma_deposits call of a variant."""
    use_laser, ion, fine, units, comps = variant
    pc, mass, normalized = UNITS[units]
    cfg = tpl.PlasmaConfig(mass=mass, can_ionize=ion)
    geom, fields = (FINE, f1) if fine else (GEOM, f0)
    kw = dict(use_laser=use_laser)
    if fine:
        kw.update(extra_mask=torch.as_tensor(mask), geom0=GEOM)
    return (_torch(lanes), COMPS[comps], _torch(fields), geom, cfg, pc,
            normalized), kw


# (order, deriv_type) of every deposit K1 takes: order 0 has no derivative
# factor of type 0
ORDER_TYPES = [(order, dt) for order in (0, 1, 2, 3) for dt in (0, 1, 2)
               if order + dt >= 1]


@pytest.mark.parametrize("order, deriv_type", ORDER_TYPES)
def test_deposits_equal_the_deposits_before(order, deriv_type):
    """fused_plasma_deposits (its values from deposit_values, the plain
    version on the CPU) against the function before its lane algebra
    moved, bit for bit, in every variant; deposit_values_plain's lanes
    against the dispatcher's."""
    lanes, f0, f1, mask = values_case(10 * order + deriv_type)
    for variant in VARIANTS:
        (p, comps, fields, geom, cfg, pc, normalized), kw = _call(
            lanes, f0, f1, mask, variant)
        args = (p, comps, fields, geom, cfg, pc, order, normalized)
        ref = _deposits_before(*args, deriv_type=deriv_type, **kw)
        got = tpl.fused_plasma_deposits(*args, deriv_type=deriv_type, **kw)
        _same(got, ref, variant)
        plain = dv_ops.deposit_values_plain(*args, deriv_type=deriv_type,
                                            **kw)
        disp = dv_ops.deposit_values(*args, deriv_type=deriv_type, **kw)
        for a, b in zip(disp, plain):
            assert torch.equal(a, b), variant
        assert torch.equal(plain[3], got[1]["w"]), variant
        assert torch.equal(plain[4], got[1]["valid"]), variant
        codes = dv_ops.value_codes(comps, deriv_type, kw["use_laser"])
        assert plain[0].shape == (len(codes), lanes["x"].size), variant


def test_the_lanes_meet_every_branch():
    """The case holds dead lanes, lanes that fail the quasi-static test by
    psi and by gamma (and so leave valid), and masked-out fine lanes; the
    laser and the ion levels each move the values."""
    lanes, f0, f1, mask = values_case(3)
    outs = {}
    for laser in (False, True):
        for ion in (False, True):
            (p, comps, fields, geom, cfg, pc, normalized), kw = _call(
                lanes, f0, f1, mask, (laser, ion, False, "normalized",
                                      "every"))
            outs[laser, ion] = dv_ops.deposit_values_plain(
                p, comps, fields, geom, cfg, pc, 2, normalized, **kw)
    rows, ym, _, w, valid = outs[False, False]
    start = torch.as_tensor(lanes["valid"])
    dropped = start & ~valid
    assert int((~start).sum()) > 20 and int(dropped.sum()) > 20
    assert bool((torch.as_tensor(lanes["psi"])[dropped] < 0).any())
    assert bool((torch.as_tensor(lanes["psi"])[dropped] > 0).any())
    assert bool((w[dropped] == 0).all())
    assert bool((ym[~start] == 2.0 * GEOM.slice_shape[0]).all())
    assert not torch.equal(rows, outs[True, False][0])
    assert not torch.equal(rows, outs[False, True][0])
    assert not torch.equal(outs[True, True][0], outs[True, False][0])


@pytest.mark.parametrize("use_laser", [False, True])
def test_rows_of_one_code_hold_one_value(use_laser):
    """Rows with the same value code hold the same values, across the
    derivative types' row orders and the main channels' orders (rho and
    rho_<species> share one): the kernel writes each code's value into its
    rows."""
    lanes, f0, f1, mask = values_case(4)
    rows_by_code = {}
    for deriv_type in (0, 1, 2):
        for comps in COMPS.values():
            cfg = tpl.PlasmaConfig()
            rows = dv_ops.deposit_values_plain(
                _torch(lanes), comps, _torch(f0), GEOM, cfg, NORMALIZED, 2,
                True, deriv_type, use_laser)[0]
            codes = dv_ops.value_codes(comps, deriv_type, use_laser)
            assert len(codes) == rows.shape[0]
            for code, row in zip(codes, rows):
                if code in rows_by_code:
                    assert torch.equal(row, rows_by_code[code]), code
                rows_by_code[code] = row
    want = set(range(6)) | set(range(6, 11 + int(use_laser))) | set(
        range(12, 16))
    assert set(rows_by_code) == want


CHOICES = {
    # case: (order, deriv_type, whether the kernel has code for it)
    "order 2, centred": (2, 2, True),
    "order 0, type 0": (0, 0, True),
    "order 3, type 1": (3, 1, True),
    "order 4": (4, 2, False),
    "plain weights": (2, -1, False),
}


def _refusal(order, deriv_type):
    """What deposit_values_cuda says of a call at order and deriv_type on
    CPU tensors: it checks the order and type first, then the tensors."""
    lanes, f0, f1, mask = values_case(5)
    (p, comps, fields, geom, cfg, pc, normalized), kw = _call(
        lanes, f0, f1, mask, (True, False, False, "normalized", "four"))
    with pytest.raises(ValueError) as err:
        dv_ops.deposit_values_cuda(p, comps, fields, geom, cfg, pc, order,
                                   normalized, deriv_type=deriv_type, **kw)
    return str(err.value)


@pytest.mark.parametrize("case", list(CHOICES))
def test_the_kernel_is_chosen_by_order_and_type(case):
    """An order or type the kernel has no code for is refused before
    anything else; the others reach the tensors' checks (here the CPU's
    tensors, which the kernel refuses)."""
    order, deriv_type, want = CHOICES[case]
    said = _refusal(order, deriv_type)
    if want:
        assert said == "x must be a CUDA tensor, got cpu"
    else:
        assert said == (f"unsupported order {order} / deriv_type "
                        f"{deriv_type}")


DECKS = {"explicit.2047's": lambda: pdf_beam(31, 8, 1000),
         "laser.2047's": lambda: laser_wake(31, 8),
         "MR": lambda: mr_wake(31, 8, 1000, 15)}


@pytest.mark.parametrize("case", list(DECKS))
def test_the_explicit_decks_take_the_kernel(case):
    sim = Simulation(DECKS[case](), device="cpu", verbose=0)
    assert sim.cfg.explicit
    assert _refusal(sim.cfg.depos_order_xy, sim.cfg.depos_derivative_type
                    ) == "x must be a CUDA tensor, got cpu"


def test_the_counters_count_only_on_the_card(monkeypatch):
    """On the CPU the kernel's launches do not count. With a device that
    takes kernels (a stand-in here, with the kernel replaced by a recorder
    that runs the plain version and K1 by its plain version) the call goes
    to the kernel."""
    lanes, f0, f1, mask = values_case(5)
    (p, comps, fields, geom, cfg, pc, normalized), kw = _call(
        lanes, f0, f1, mask, (True, False, False, "normalized", "four"))
    args = (p, comps, fields, geom, cfg, pc, 2, normalized)
    before = dv_ops.deposit_values.launches
    ref = tpl.fused_plasma_deposits(*args, **kw)
    assert dv_ops.deposit_values.launches == before

    calls = []

    def kernel(*a, **k):
        calls.append("kernel")
        return dv_ops.deposit_values_plain(*a, **k)

    monkeypatch.setattr(cuda_lib, "use_kernel", lambda t: True)
    monkeypatch.setattr(dv_ops, "deposit_values_cuda", kernel)
    monkeypatch.setattr(tpl, "deposit",
                        lambda f, ym, xm, v, order, deriv_type=-1,
                        blocks=None, lattice_width=None: deposit_plain(
                            f, ym, xm, v, order, deriv_type, blocks))
    got = tpl.fused_plasma_deposits(*args, **kw)
    _same(got, ref, "kernel")
    assert calls == ["kernel"]


def test_values_params_are_the_plain_scalars():
    """The kernel's scalars are the Python floats the plain version hands
    its ops (the cell positions' 1/dx and 1/dy in double, which the kernel
    rounds to the working type as PyTorch's division by a scalar does on
    the card); on a fine level the level-0 density."""
    cfg = tpl.PlasmaConfig(mass=1.3, max_qsa_weighting_factor=20.5)
    for geom, geom0, normalized in ((GEOM, None, False), (FINE, GEOM, True)):
        prm = dict(zip(dv_ops.PARAMS, dv_ops.values_params(
            geom, geom0, cfg, C17, normalized)))
        invvol = tpl.deposit_invvol(geom, geom0, normalized)
        if geom0 is None:
            assert invvol == 1.0 / (geom.dx * geom.dy * geom.dz)
        else:
            assert invvol == GEOM.dx * GEOM.dy / (FINE.dx * FINE.dy)
        assert prm["q_invvol"] == -1.0 * invvol
        assert prm["q_mu0_m"] == -1.0 * 1.3 / 1.3
        assert prm["q_m"] == -1.0 / 1.3
        assert prm["lnorm"] == tpl.laser_norm(cfg, C17)
        assert prm["cin"] == 1.0 / 1.7 and prm["clight"] == 1.7
        assert prm["cd_mu0"] == -1.0 * invvol * 1.3
        assert prm["max_qsa"] == 20.5
        assert prm["inv_dx"] == 1.0 / geom.dx
        assert prm["inv_dy"] == 1.0 / geom.dy
        assert (prm["x_off"], prm["y_off"]) == (geom.x_pos_offset,
                                                geom.y_pos_offset)
        assert prm["guards"] == geom.nguards
