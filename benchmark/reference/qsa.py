"""The plain reference: one quasi-static time step of the transverse
benchmark deck in plain PyTorch.

A frozen copy, cut down to what the benchmark's configurations run, of the
plain versions and slice equations of ``hipace_tpu_torch`` as of the commit
that added this benchmark (origin of each part in its docstring): the order
2 shapes (``ops/shape.py``), the exact ``index_add_`` deposit
(``ops/deposit.py`` ``deposit_plain``) and gather (``ops/gather.py``
``gather_main_plain``), the DST-I Poisson solver (``ops/dst.py``,
``fields/poisson.py``), the node-centered multigrid
(``fields/multigrid.py`` ``solve_plain``), the plasma lattice, deposits and
leapfrog push (``particles/plasma.py``), the beam's binning, deposit and
push (``particles/beam.py``) and the slice step of the explicit Bx/By
solver (``pipeline/step.py``, ``pipeline/simulation.py`` ``_time_step``).
What the configurations do not use is left out: the predictor-corrector
Bx/By solver, lasers, mesh refinement, SALAME, ionization, collisions,
open boundaries, several species, AB5, spin and radiation reaction,
diagnostics other than the field stack.

It imports nothing of the program and takes nothing the program made: the
deck's numbers come from the benchmark's configuration file, the beam from
the benchmark's draw or, where the check follows the program step by step,
the program's beam at the start of a step.

Normalized units (c = ep0 = mu0 = q_e = m_e = 1); the dtype is the
tensors'.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

# the lanes of a deposit or gather with ym >= LIVE * NY are dead
LIVE = 1.5
BEAM_FLOAT = ("x", "y", "z", "ux", "uy", "uz", "w")


@dataclasses.dataclass(frozen=True)
class Deck:
    """The numbers of a configuration that the step reads."""
    nx: int
    ny: int
    nz: int
    prob_lo: tuple
    prob_hi: tuple
    dt: float = 1.0
    plasma_density: float = 1.0
    beam_subcycles: int = 10
    mg_tol_rel: float = 1e-4
    mg_max_iters: int = 40
    max_qsa_weighting_factor: float = 35.0
    guards: int = 2

    @classmethod
    def from_config(cls, cfg: dict) -> "Deck":
        if cfg["hipace.bxby_solver"] != "explicit":
            raise ValueError("the reference runs the explicit Bx/By solver "
                             f"only, not {cfg['hipace.bxby_solver']!r}")
        r = cfg["reference"]
        nx, ny, nz = cfg["amr.n_cell"]
        return cls(nx=nx, ny=ny, nz=nz,
                   prob_lo=tuple(cfg["geometry.prob_lo"]),
                   prob_hi=tuple(cfg["geometry.prob_hi"]),
                   dt=cfg["hipace.dt"], plasma_density=r["plasma_density"],
                   beam_subcycles=r["beam_subcycles"],
                   mg_tol_rel=r["mg_tol_rel"])

    def d(self, k):
        n = (self.nx, self.ny, self.nz)[k]
        return (self.prob_hi[k] - self.prob_lo[k]) / n

    @property
    def shape(self):
        return (self.ny + 2 * self.guards, self.nx + 2 * self.guards)


# ---------------------------------------------------------------- shapes
def bspline2(u):
    """B_2(u) (ops/shape.py bspline, p = 2)."""
    au = torch.abs(u)
    t = 1.5 - au
    return torch.where(au <= 0.5, 0.75 - au * au,
                       torch.where(au < 1.5, 0.5 * (t * t),
                                   torch.zeros_like(u)))


def leftmost2(xm):
    return torch.floor(xm + 0.5).to(torch.int64) - 1


# --------------------------------------------------------- deposit, gather
def deposit(fields, ym, xm, values, deriv=False):
    """fields (C, NY, NX) += the order-2 deposit of values (C, N) at the
    guard-offset cell positions (ops/deposit.py deposit_plain): deriv=True
    is derivative type 2's five-tap stencil with plain weights."""
    C, NY, NX = fields.shape
    live = ym < LIVE * NY
    ym, xm, values = ym[live], xm[live], values[:, live]
    m = 5 if deriv else 3
    offs = torch.arange(m, device=ym.device)
    shift = 1 if deriv else 0
    iy = (leftmost2(ym) - shift)[:, None] + offs
    ix = (leftmost2(xm) - shift)[:, None] + offs
    wy = bspline2(ym[:, None] - iy.to(ym.dtype)) * ((iy >= 0) & (iy < NY))
    wx = bspline2(xm[:, None] - ix.to(xm.dtype)) * ((ix >= 0) & (ix < NX))
    lin = (iy.clamp(0, NY - 1)[:, :, None] * NX
           + ix.clamp(0, NX - 1)[:, None, :]).reshape(-1)
    flat = fields.view(C, NY * NX)
    for c in range(C):
        w = (values[c][:, None, None] * wy[:, :, None]) * wx[:, None, :]
        flat[c].index_add_(0, lin, w.reshape(-1))
    return fields


def gather(planes, ym, xm):
    """(-dPsi/dx, -dPsi/dy in cell units, Ez, Bx, By, Bz) at the lanes from
    the planes (Psi, Ez, Bx, By, Bz) (ops/gather.py gather_main_plain,
    order 2: the order-2 weights and the nodal derivative factors of
    derivative type 1, on four taps)."""
    NY, NX = planes[0].shape
    live = ym < LIVE * NY

    def axis(pos, n):
        i0 = torch.floor(pos).to(torch.int64) - 1
        offs = torch.arange(4, device=pos.device)
        i = i0[:, None] + offs
        u = pos[:, None] - i.to(pos.dtype)
        w = bspline2(u)
        dw = -(bspline2(u + 0.5) - bspline2(u - 0.5))
        ok = ((i >= 0) & (i < n)).to(pos.dtype)
        return i, w * ok, dw * ok

    iy, wy, dwy = axis(ym, NY)
    ix, wx, dwx = axis(xm, NX)
    lin = (iy.clamp(0, NY - 1)[:, :, None] * NX
           + ix.clamp(0, NX - 1)[:, None, :])
    flat = lin.reshape(-1)
    vals = [p.reshape(NY * NX).index_select(0, flat).view(lin.shape)
            for p in planes]
    w = wy[:, :, None] * wx[:, None, :]
    out = torch.stack([((wy[:, :, None] * dwx[:, None, :]) * vals[0])
                       .sum(dim=(1, 2)),
                       ((dwy[:, :, None] * wx[:, None, :]) * vals[0])
                       .sum(dim=(1, 2))]
                      + [(w * vals[c]).sum(dim=(1, 2)) for c in range(1, 5)])
    return torch.where(live, out, torch.zeros_like(out))


# ------------------------------------------------------------- the grid
def interior(f, dk: Deck):
    G = dk.guards
    NY, NX = dk.shape
    return f[..., G:NY - G, G:NX - G]


def set_interior(f, u, dk: Deck):
    out = f.clone()
    interior(out, dk).copy_(u)
    return out


def ddx(f, dk: Deck):
    G = dk.guards
    NY, NX = dk.shape
    return (f[..., G:NY - G, G + 1:NX - G + 1]
            - f[..., G:NY - G, G - 1:NX - G - 1]) * (0.5 / dk.d(0))


def ddy(f, dk: Deck):
    G = dk.guards
    NY, NX = dk.shape
    return (f[..., G + 1:NY - G + 1, G:NX - G]
            - f[..., G - 1:NY - G - 1, G:NX - G]) * (0.5 / dk.d(1))


def grad_neg(psi, dk: Deck):
    exmby = torch.zeros_like(psi)
    eypbx = torch.zeros_like(psi)
    exmby[:, 1:-1] = -(psi[:, 2:] - psi[:, :-2]) * (0.5 / dk.d(0))
    eypbx[1:-1, :] = -(psi[2:, :] - psi[:-2, :]) * (0.5 / dk.d(1))
    return exmby, eypbx


def cell_positions(x, y, mask, dk: Deck):
    G = dk.guards
    NY, NX = dk.shape
    xm = (x - (dk.prob_lo[0] + 0.5 * dk.d(0))) / dk.d(0) + G
    ym = (y - (dk.prob_lo[1] + 0.5 * dk.d(1))) / dk.d(1) + G
    return (torch.where(mask, ym, torch.full_like(ym, 2.0 * NY)),
            torch.where(mask, xm, torch.full_like(xm, 2.0 * NX)))


def periodic(x, y, dk: Deck):
    lo0, lo1, hi0, hi1 = dk.prob_lo[0], dk.prob_lo[1], dk.prob_hi[0], \
        dk.prob_hi[1]
    out = (x < lo0) | (x > hi0) | (y < lo1) | (y > hi1)
    x = torch.where(out, lo0 + torch.remainder(x - lo0, hi0 - lo0), x)
    y = torch.where(out, lo1 + torch.remainder(y - lo1, hi1 - lo1), y)
    return x, y


# ---------------------------------------------------------------- solvers
def dst1(x):
    """DST-I along the last axis (ops/dst.py dst1_fast)."""
    n = x.shape[-1]
    m = n + 1
    j = torch.arange(1, m, dtype=torch.float64, device=x.device)
    sin_j = torch.sin(j * (math.pi / m)).to(x.dtype)
    xr = x.flip(-1)
    y1 = sin_j * (x + xr) + 0.5 * (x - xr)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(torch.cat([zero, y1], dim=-1), dim=-1)
    odd = -spec.imag[..., 1:]
    re = spec.real
    even = torch.cumsum(torch.cat([0.5 * re[..., :1], re[..., 1:-1]], -1), -1)
    ne = even.shape[-1]
    out = torch.stack([even, odd[..., :ne]], dim=-1)
    return out.reshape(x.shape[:-1] + (2 * ne,))[..., :n].to(x.dtype)


def dst2(x):
    return dst1(dst1(x).transpose(-1, -2)).transpose(-1, -2)


class Poisson:
    """Laplacian(u) = rhs with zero ghost nodes (fields/poisson.py
    DirichletPoissonSolver, the fast variant)."""

    def __init__(self, dk: Deck, device, dtype):
        nx, ny, dx, dy = dk.nx, dk.ny, dk.d(0), dk.d(1)
        sx = np.sin((np.arange(nx) + 1) * math.pi / (2 * (nx + 1))) ** 2
        sy = np.sin((np.arange(ny) + 1) * math.pi / (2 * (ny + 1))) ** 2
        lam = -4.0 * (sx[None, :] / (dx * dx) + sy[:, None] / (dy * dy))
        self.inv = torch.as_tensor(4.0 / ((nx + 1) * (ny + 1)) / lam,
                                   dtype=dtype, device=device)

    def solve(self, rhs):
        return dst2(dst2(rhs) * self.inv)


def _restrict_matrix(nf):
    nc = (nf - 1) // 2
    R = np.zeros((nc, nf))
    for ic in range(nc):
        R[ic, 2 * ic:2 * ic + 3] = (0.25, 0.5, 0.25)
    return R


def mg_levels(nx, ny):
    """The node-centered levels' (ny, nx) (fields/multigrid.py)."""
    shapes = [(ny, nx)]
    while True:
        n_y, n_x = shapes[-1]
        if ((n_x - 1) % 2 or (n_y - 1) % 2 or (n_x - 1) // 2 < 3
                or (n_y - 1) // 2 < 3):
            return shapes
        shapes.append(((n_y - 1) // 2, (n_x - 1) // 2))


class MultiGrid:
    """Laplacian(u) - acf u = rhs, node-centered, red-black Gauss-Seidel
    V-cycles (fields/multigrid.py MultiGrid.solve_plain, odd sizes)."""

    def __init__(self, dk: Deck, device, dtype):
        self.shapes = mg_levels(dk.nx, dk.ny)
        self.facs, self.red, self.R, self.den = [], [], [], []
        ddx, ddy = dk.d(0), dk.d(1)
        for lev, (n_y, n_x) in enumerate(self.shapes):
            self.facs.append((1.0 / (ddx * ddx), 1.0 / (ddy * ddy)))
            ddx, ddy = 2 * ddx, 2 * ddy
            red = (np.add.outer(np.arange(n_y), np.arange(n_x)) % 2) == 0
            self.red.append(torch.as_tensor(red, device=device))
            if lev + 1 < len(self.shapes):
                ry, rx = _restrict_matrix(n_y), _restrict_matrix(n_x)
                self.R.append((torch.as_tensor(ry, dtype=dtype,
                                               device=device),
                               torch.as_tensor(rx, dtype=dtype,
                                               device=device)))
                self.den.append(torch.as_tensor(
                    ry @ np.ones((n_y, n_x)) @ rx.T, dtype=dtype,
                    device=device))
        self.cycles = 0

    def _off(self, u, lev):
        fx, fy = self.facs[lev]
        up = F.pad(u, (1, 1, 1, 1))
        return (fx * (up[..., 1:-1, :-2] + up[..., 1:-1, 2:])
                + fy * (up[..., 2:, 1:-1] + up[..., :-2, 1:-1]))

    def _smooth(self, u, rhs, inv, lev, sweeps):
        for _ in range(sweeps):
            for mask in (self.red[lev], ~self.red[lev]):
                u = torch.where(mask, inv * (rhs - self._off(u, lev)), u)
        return u

    def _vcycle(self, u, rhs, coefs, lev):
        dma, inv = coefs[lev]
        u = self._smooth(u, rhs, inv, lev, 2)
        if lev + 1 < len(self.shapes):
            res = rhs - (self._off(u, lev) + dma * u)
            ry, rx = self.R[lev]
            crhs = ry @ res @ rx.T
            cu = self._vcycle(torch.zeros_like(crhs), crhs, coefs, lev + 1)
            u = u + (2.0 * ry).T @ cu @ (2.0 * rx)
            u = self._smooth(u, rhs, inv, lev, 2)
        else:
            u = self._smooth(u, rhs, inv, lev, 8)
        return u

    def solve(self, u0, rhs, acf, tol_rel, max_iters):
        acfs = [acf]
        for lev in range(len(self.shapes) - 1):
            ry, rx = self.R[lev]
            acfs.append((ry @ acfs[-1] @ rx.T) / self.den[lev])
        coefs = []
        for lev, a in enumerate(acfs):
            fx, fy = self.facs[lev]
            dma = -2.0 * (fx + fy) - a
            coefs.append((dma, 1.0 / dma))

        def resnorm(u):
            r = rhs - (self._off(u, 0) + coefs[0][0] * u)
            return float(torch.max(torch.abs(r)))

        res = resnorm(u0)
        t = max(tol_rel, 1e-16) * max(res, float(torch.max(torch.abs(rhs))))
        target = float(torch.tensor(t, dtype=rhs.dtype))
        u, it = u0, 0
        while res > target and it < max_iters:
            u = self._vcycle(u, rhs, coefs, 0)
            res = resnorm(u)
            it += 1
        self.cycles = it
        return u


# ----------------------------------------------------------------- plasma
def init_plasma(dk: Deck, device, dtype):
    """The 1 ppc electron lattice at rest (particles/plasma.py
    init_plasma): lanes y-major, x fastest."""
    f64 = dict(dtype=torch.float64, device=device)
    X = dk.prob_lo[0] + (torch.arange(dk.nx, **f64)[None, :] + 0.5) * dk.d(0)
    Y = dk.prob_lo[1] + (torch.arange(dk.ny, **f64)[:, None] + 0.5) * dk.d(1)
    shape = (dk.ny, dk.nx)
    x = torch.broadcast_to(X, shape).reshape(-1).to(dtype)
    y = torch.broadcast_to(Y, shape).reshape(-1).to(dtype)
    w = torch.full_like(x, dk.plasma_density)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return {"x": x, "y": y, "w": w, "ux": zero, "uy": zero, "psi": one,
            "x_prev": x, "y_prev": y, "ux_half": zero, "uy_half": zero,
            "psi_half": one, "valid": torch.ones_like(x, dtype=torch.bool)}


def _dmom(ux, uy, psi_inv, f):
    """PlasmaMomentumPush for charge -1, mass 1, c = 1."""
    exmby, eypbx, ez, bx, by, bz = f
    gp = 0.5 * psi_inv * psi_inv * (1.0 + ux * ux + uy * uy) + 0.5
    return (-(gp * exmby + by + uy * bz * psi_inv),
            -(gp * eypbx - bx - ux * bz * psi_inv),
            -((ux * exmby + uy * eypbx) * psi_inv - ez))


def _dmom_jvp(ux, uy, psi, dux, duy, dpsi, f):
    exmby, eypbx, ez, bx, by, bz = f
    pi = 1.0 / psi
    dpi = -pi * pi * dpsi
    s = 1.0 + ux * ux + uy * uy
    ds = 2.0 * (ux * dux + uy * duy)
    dg = pi * dpi * s + 0.5 * pi * pi * ds
    return (-(dg * exmby + bz * (duy * pi + uy * dpi)),
            -(dg * eypbx - bz * (dux * pi + ux * dpi)),
            -((dux * exmby + duy * eypbx) * pi + (ux * exmby + uy * eypbx)
              * dpi))


def _substep(ux, uy, psi, sdz, f):
    d = _dmom(ux, uy, 1.0 / psi, f)
    d2 = _dmom_jvp(ux, uy, psi, *d, f)
    h = 0.5 * sdz * sdz
    return (ux + sdz * d[0] + h * d2[0], uy + sdz * d[1] + h * d2[1],
            psi + sdz * d[2] + h * d2[2])


def gather_fields(this, x, y, mask, dk: Deck):
    ym, xm = cell_positions(x, y, mask, dk)
    o = gather([this[c] for c in ("Psi", "Ez", "Bx", "By", "Bz")], ym, xm)
    return (o[0] / dk.d(0), o[1] / dk.d(1), o[2], o[3], o[4], o[5])


def push_plasma(p, this, dk: Deck):
    """The leapfrog push to the next slice (particles/plasma.py
    advance_plasma, one subcycle)."""
    dz = dk.d(2)
    f = gather_fields(this, p["x_prev"], p["y_prev"], p["valid"], dk)
    sdz = dz / 4
    ux, uy, psi = p["ux_half"], p["uy_half"], p["psi_half"]
    for _ in range(4):
        ux, uy, psi = _substep(ux, uy, psi, sdz, f)
    x, y = periodic(p["x_prev"] + dz * ux / psi, p["y_prev"] + dz * uy / psi,
                    dk)
    out = dict(p)
    out.update(x_prev=x, y_prev=y, ux_half=ux, uy_half=uy, psi_half=psi)
    for _ in range(2):
        ux, uy, psi = _substep(ux, uy, psi, sdz, f)
    out.update(x=x, y=y, ux=ux, uy=uy, psi=psi)
    return out


def _plasma_terms(p, dk: Deck):
    psi_inv = 1.0 / p["psi"]
    vx, vy = p["ux"] * psi_inv, p["uy"] * psi_inv
    gp = 0.5 * (psi_inv * psi_inv + vx * vx + vy * vy + 1.0)
    bad = (gp < 0.0) | (gp > dk.max_qsa_weighting_factor) | (psi_inv < 0.0)
    wmask = (p["valid"] & ~bad).to(psi_inv.dtype)
    return psi_inv, vx, vy, gp, wmask, bad


def deposit_plasma(p, fields, comps, dk: Deck, flip=False):
    """The plasma's currents (particles/plasma.py deposit_plasma), charge
    -1 (+1 flipped)."""
    q = 1.0 if flip else -1.0
    psi_inv, vx, vy, gp, wmask, bad = _plasma_terms(p, dk)
    qv = q * p["w"] * wmask
    vals = {"jx": qv * vx, "jy": qv * vy, "jz": qv * (gp - 1.0),
            "rhomjz": qv, "chi": qv * q * psi_inv}
    ym, xm = cell_positions(p["x"], p["y"], p["valid"], dk)
    stack = torch.stack([fields[c] for c in comps])
    deposit(stack, ym, xm, torch.stack([vals[c] for c in comps]))
    out = dict(fields)
    out.update(zip(comps, stack))
    return out, dict(p, w=p["w"] * wmask, valid=p["valid"] & ~bad)


def fused_deposit(p, this, dk: Deck):
    """The explicit solver's plasma deposit with the Sx/Sy coefficient
    channels, derivative type 2 (particles/plasma.py
    fused_plasma_deposits); returns (this, p, (d1, d2, d3))."""
    psi_inv, vx, vy, gp, wmask, bad = _plasma_terms(p, dk)
    qv = -p["w"] * wmask
    vals = [qv * vx, qv * vy, qv * -1.0 * psi_inv, qv]
    base = qv * -psi_inv
    chans = [base * vx, base * vy, base * vx * vy, base * (gp - vy * vy),
             base * (gp - vx * vx)]
    v2 = [qv / dk.d(0) * vx * vy, qv / dk.d(0) * (gp - vx * vx - 1.0)]
    v3 = [-qv / dk.d(1) * (gp - vy * vy - 1.0), -qv / dk.d(1) * vx * vy]
    comps = ("jx", "jy", "chi", "rhomjz")
    acc = torch.cat([torch.stack([this[c] for c in comps]),
                     torch.zeros((9,) + dk.shape, dtype=qv.dtype,
                                 device=qv.device)])
    ym, xm = cell_positions(p["x"], p["y"], p["valid"], dk)
    deposit(acc, ym, xm, torch.stack(vals + chans + v2 + v3), deriv=True)
    out = dict(this)
    out.update(zip(comps, acc[:4]))
    return out, dict(p, w=p["w"] * wmask, valid=p["valid"] & ~bad), \
        (acc[4:9], acc[9:11], acc[11:13])


def combine_sxsy(this, dgrids):
    """Sx/Sy from the coefficient grids (particles/plasma.py
    combine_explicit_sxsy, derivative type 2)."""
    d1, d2, d3 = dgrids
    z = torch.zeros_like(d2[:, :, :1])
    d2 = 0.5 * (torch.cat([d2[:, :, 1:], z], 2) - torch.cat([z, d2[:, :, :-1]],
                                                             2))
    zr = torch.zeros_like(d3[:, :1, :])
    d3 = 0.5 * (torch.cat([d3[:, 1:, :], zr], 1)
                - torch.cat([zr, d3[:, :-1, :]], 1))
    out = dict(this)
    out["Sy"] = (this["Sy"] + this["Bz"] * d1[0] - this["Ez"] * d1[1]
                 + this["ExmBy"] * d1[2] - this["EypBx"] * d1[3] + d2[0]
                 + d3[0])
    out["Sx"] = (this["Sx"] + this["Bz"] * d1[1] + this["Ez"] * d1[0]
                 + this["ExmBy"] * d1[4] - this["EypBx"] * d1[2] + d2[1]
                 + d3[1])
    return out


# ------------------------------------------------------------------- beam
BEAM_ALL = BEAM_FLOAT + ("nsub", "valid")


def bin_beam(beam, dk: Deck):
    """The beam's lanes by slice (particles/beam.py bin_beam, without a
    capacity): a list of nz dicts of the lanes of each slice, in the
    order of the flat lanes."""
    isl = torch.floor((beam["z"] - dk.prob_lo[2]) / dk.d(2)).to(torch.int64)
    ok = beam["valid"] & (isl >= 0) & (isl < dk.nz)
    isl = torch.where(ok, isl, torch.full_like(isl, dk.nz))
    s, order = torch.sort(isl, stable=True)
    counts = torch.bincount(s, minlength=dk.nz + 1)[:dk.nz].tolist()
    out, start = [], 0
    for n in counts:
        idx = order[start:start + n]
        out.append({k: beam[k][idx] for k in BEAM_ALL})
        start += n
    return out


def deposit_beam(bp, fields, cmap, dk: Deck):
    """The beam's currents, charge -1 (particles/beam.py
    deposit_beam_slice)."""
    gam_inv = 1.0 / torch.sqrt(1.0 + bp["ux"] ** 2 + bp["uy"] ** 2
                               + bp["uz"] ** 2)
    wq = torch.where(bp["valid"], -bp["w"], torch.zeros_like(bp["w"]))
    vals = {"jx": wq * bp["ux"] * gam_inv, "jy": wq * bp["uy"] * gam_inv,
            "jz": wq * bp["uz"] * gam_inv}
    stack = torch.stack([fields[cmap[q]] for q in cmap])
    ym, xm = cell_positions(bp["x"], bp["y"], bp["valid"], dk)
    deposit(stack, ym, xm, torch.stack([vals[q] for q in cmap]))
    out = dict(fields)
    out.update((cmap[q], stack[i]) for i, q in enumerate(cmap))
    return out


def push_beam(bp, this, dk: Deck, min_z):
    """The beam's push over dt in subcycles, charge -1, mass 1
    (particles/beam.py advance_beam_slice without spin, radiation and
    external fields); a lane that slips below min_z stops and keeps its
    subcycle count."""
    n = dk.beam_subcycles
    dt = dk.dt / n
    x, y, z, ux, uy, uz = (bp[k] for k in ("x", "y", "z", "ux", "uy", "uz"))
    valid, nsub0 = bp["valid"], bp["nsub"]
    stopped = torch.zeros_like(valid)
    nsub = nsub0
    for i in range(n):
        slipped = z < min_z
        active = valid & (nsub0 <= i) & ~stopped & ~slipped
        stopped = stopped | (slipped & valid & (nsub0 <= i))
        gi = 1.0 / torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
        xh, yh = periodic(x + dt * 0.5 * ux * gi, y + dt * 0.5 * uy * gi, dk)
        exmby, eypbx, ez, bx, by, bz = gather_fields(this, xh, yh, valid, dk)
        uxn = ux - dt * (exmby + (1.0 - uz * gi) * by + uy * gi * bz)
        uyn = uy - dt * (eypbx + (uz * gi - 1.0) * bx - ux * gi * bz)
        uxm, uym = 0.5 * (uxn + ux), 0.5 * (uyn + uy)
        uzm = uz - dt * 0.5 * ez
        gmi = 1.0 / torch.sqrt(1.0 + uxm * uxm + uym * uym + uzm * uzm)
        uzn = uz - dt * (ez + (uxm * by - uym * bx) * gmi)
        gni = 1.0 / torch.sqrt(1.0 + uxn * uxn + uyn * uyn + uzn * uzn)
        x = torch.where(active, xh + dt * 0.5 * uxn * gni, x)
        y = torch.where(active, yh + dt * 0.5 * uyn * gni, y)
        z = torch.where(active, z + dt * (uzn * gni - 1.0), z)
        ux = torch.where(active, uxn, ux)
        uy = torch.where(active, uyn, uy)
        uz = torch.where(active, uzn, uz)
        nsub = torch.where(active, torch.full_like(nsub, i + 1), nsub)
    nsub = torch.where(nsub >= n, torch.zeros_like(nsub), nsub)
    return dict(bp, x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, nsub=nsub)


# ------------------------------------------------------------- the step
class Step:
    """One time step of the deck (pipeline/simulation.py _time_step and
    pipeline/step.py SliceStep): the plasma and its neutralizing background
    anew, the sweep from the head slice to the tail, the beam's lanes
    re-binned. ``run`` yields, per slice in sweep order, (islice, the
    slice's field stack by name) and returns the pushed beam's flat lanes,
    in the program's order: per slice the slipped lanes of the slice before
    and then its own, the lanes still slipping last."""

    def __init__(self, dk: Deck, device, dtype):
        self.dk, self.device, self.dtype = dk, device, dtype
        self.poisson = Poisson(dk, device, dtype)
        self.mg = MultiGrid(dk, device, dtype)
        self.cycles = []

    def zeros(self, *names):
        return {c: torch.zeros(self.dk.shape, dtype=self.dtype,
                               device=self.device) for c in names}

    def run(self, flat_beam):
        dk = self.dk
        plasma = init_plasma(dk, self.device, self.dtype)
        ions, _ = deposit_plasma(plasma, self.zeros("rhomjz"), ["rhomjz"],
                                 dk, flip=True)
        ions = ions["rhomjz"]
        slices = bin_beam(flat_beam, dk)
        f = {"This": self.zeros("chi", "Sy", "Sx", "ExmBy", "EypBx", "Ez",
                                "Bx", "By", "Bz", "Psi", "jx_beam", "jy_beam",
                                "jz_beam", "jx", "jy", "rhomjz"),
             "Next": self.zeros("jx_beam", "jy_beam"),
             "Previous": self.zeros("jx_beam", "jy_beam")}
        slip = {k: v[:0] for k, v in slices[0].items()}
        emitted = [None] * dk.nz
        self.cycles = []
        for islice in range(dk.nz - 1, -1, -1):
            nxt = slices[islice - 1] if islice else {
                k: v[:0] for k, v in slices[0].items()}
            f, plasma, this = self._slice(f, plasma, ions, slices[islice],
                                          nxt, islice)
            yield islice, this
            combined = {k: torch.cat([slip[k], slices[islice][k]])
                        for k in BEAM_ALL}
            combined = push_beam(combined, this, dk,
                                 dk.prob_lo[2] + islice * dk.d(2))
            inc = combined["valid"] & (combined["nsub"] > 0)
            slip = {k: v[inc] for k, v in combined.items()}
            emitted[islice] = {k: v[~inc & combined["valid"]]
                               for k, v in combined.items()}
        return {k: torch.cat([e[k] for e in emitted] + [slip[k]])
                for k in BEAM_ALL}

    def _psi_ez_bz(self, this):
        dk = self.dk
        rhs = torch.stack([-interior(this["rhomjz"], dk),
                           ddx(this["jx"], dk) + ddy(this["jy"], dk),
                           ddy(this["jx"], dk) - ddx(this["jy"], dk)])
        sol = self.poisson.solve(rhs)
        this = dict(this)
        for i, c in enumerate(("Psi", "Ez", "Bz")):
            this[c] = set_interior(this[c], sol[i], dk)
        this["ExmBy"], this["EypBx"] = grad_neg(this["Psi"], dk)
        return this

    def _slice(self, f, plasma, ions, beam_this, beam_next, islice):
        dk = self.dk
        this = dict(f["This"])
        for c in ("chi", "Sy", "Sx", "ExmBy", "EypBx", "jz_beam", "rhomjz"):
            this[c] = torch.zeros_like(this[c])
        nxt = {c: torch.zeros_like(v) for c, v in f["Next"].items()}
        this, plasma, dgrids = fused_deposit(plasma, this, dk)
        this = deposit_beam(beam_this, this, {"jz": "jz_beam"}, dk)
        this["rhomjz"] = this["rhomjz"] + ions
        this = self._psi_ez_bz(this)
        nxt = deposit_beam(beam_next, nxt, {"jx": "jx_beam",
                                            "jy": "jy_beam"}, dk)
        dz2 = 1.0 / (2.0 * dk.d(2))
        prev = f["Previous"]
        this["Sy"] = set_interior(this["Sy"], -ddy(this["jz_beam"], dk)
                                  + (interior(prev["jy_beam"], dk)
                                     - interior(nxt["jy_beam"], dk))
                                  * dz2, dk)
        this["Sx"] = set_interior(this["Sx"], ddx(this["jz_beam"], dk)
                                  - (interior(prev["jx_beam"], dk)
                                     - interior(nxt["jx_beam"], dk))
                                  * dz2, dk)
        this = combine_sxsy(this, dgrids)
        b0 = torch.stack([interior(this["Bx"], dk),
                          interior(this["By"], dk)])
        b = self.mg.solve(b0, torch.stack([interior(this["Sy"], dk),
                                           interior(this["Sx"], dk)]),
                          interior(this["chi"], dk), dk.mg_tol_rel,
                          dk.mg_max_iters)
        this["Bx"] = set_interior(this["Bx"], b[0], dk)
        this["By"] = set_interior(this["By"], b[1], dk)
        self.cycles.append(self.mg.cycles)
        plasma = push_plasma(plasma, this, dk)
        new_this = dict(this)
        for c in ("jx", "jy"):
            new_this[f"{c}_beam"] = nxt[f"{c}_beam"]
            new_this[c] = nxt[f"{c}_beam"]
        f = {"This": new_this, "Next": nxt,
             "Previous": {"jx_beam": this["jx_beam"],
                          "jy_beam": this["jy_beam"]}}
        return f, plasma, this
