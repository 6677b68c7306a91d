"""The plain reference of the laser-driven blowout wake: one quasi-static
time step of the laser envelope deck, explicit Bx/By solver, in plain
PyTorch.

A frozen copy, cut down to what the configuration runs, of the laser parts
of ``hipace_tpu_torch`` as of the commit that added this configuration
(origin of each part in its docstring; ``ref`` names the reference code's
file): the gaussian initial envelope (``fields/laser.py``
``envelope_slice``), the envelope advance (``LaserAdvance``, the multigrid
solver with its on-axis phase), a plain complex multigrid (``fields/
multigrid.py`` ``solve_plain``, complex path), chi on the laser grid with
the trusted-region rule (``pipeline/step.py``), the |a|^2 gather
(``ops/gather.py`` ``gather_laser_aabs``) and the laser's terms in the
plasma's fused deposit, in Sx/Sy and in the plasma push
(``particles/plasma.py``). The parts that the laser leaves as they are come
from ``qsa.py``: the shapes, the deposit and the field gather, the DST
Poisson solver, the real multigrid of Bx/By, the plasma lattice.

The deck has no beam: the beam's currents stay zero, and the Sx/Sy terms
they feed are kept for the form of the slice step. The laser grid is the
field grid (the deck sets no ``lasers.n_cell``), the laser spans every
slice, and the plasma is one species of electrons.

It imports nothing of the program and takes nothing the program made but
what a step starts from: the envelope stream (n00, nm1) at the step's
start and, where given, the plasma's lanes at the step's start (a deck
with a plasma temperature draws them from the program's generator).

Normalized units (c = ep0 = mu0 = q_e = m_e = 1); the dtype is the
tensors'. On the card the lanes' gathers and deposits run in blocks of
``BLOCK`` lanes, so that the reference fits beside what the check holds.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import qsa

# lanes per block of a gather or deposit
BLOCK = 1 << 20


@dataclasses.dataclass(frozen=True)
class LaserDeck:
    """The numbers of the laser configuration that the step reads: the
    field deck (qsa.Deck) and the pulse and its solver."""
    dk: qsa.Deck
    lambda0: float
    a0: float
    w0: float
    L0: float
    position_mean: tuple = (0.0, 0.0, 0.0)
    mg_tol_rel: float = 1e-4
    mg_max_iters: int = 40

    @classmethod
    def from_config(cls, cfg: dict) -> "LaserDeck":
        if cfg["hipace.bxby_solver"] != "explicit":
            raise ValueError("the reference runs the explicit Bx/By solver "
                             f"only, not {cfg['hipace.bxby_solver']!r}")
        r = cfg["reference"]
        las = r["laser"]
        nx, ny, nz = cfg["amr.n_cell"]
        dk = qsa.Deck(nx=nx, ny=ny, nz=nz,
                      prob_lo=tuple(cfg["geometry.prob_lo"]),
                      prob_hi=tuple(cfg["geometry.prob_hi"]),
                      dt=cfg["hipace.dt"],
                      plasma_density=r["plasma_density"],
                      mg_tol_rel=r["mg_tol_rel"])
        return cls(dk=dk, lambda0=las["lambda0"], a0=las["a0"],
                   w0=las["w0"], L0=las["L0"],
                   position_mean=tuple(las["position_mean"]),
                   mg_tol_rel=las["MG_tolerance_rel"])

    @property
    def k0(self) -> float:
        return 2.0 * math.pi / self.lambda0


# ------------------------------------------------------------ the envelope
def envelope_slice(ld: LaserDeck, islice: int, dtype, device):
    """The initial envelope of slice islice, complex (NY, NX), zero guard
    cells (fields/laser.py envelope_slice, one gaussian pulse without
    angle, focus or phase; ref MultiLaser.cpp:804-920 InitLaserSlice)."""
    dk = ld.dk
    G = dk.guards
    NY, NX = dk.shape
    x = (torch.arange(NX, dtype=dtype, device=device) - G + 0.5) * dk.d(0) \
        + dk.prob_lo[0]
    y = (torch.arange(NY, dtype=dtype, device=device) - G + 0.5) * dk.d(1) \
        + dk.prob_lo[1]
    x0, y0, z0 = ld.position_mean
    z = dk.prob_lo[2] + 0.5 * dk.d(2) + islice * dk.d(2)
    xs, ys, zs = x[None, :] - x0, y[:, None] - y0, z - z0
    diffract = 1.0 + 1j * (zs + z0) * 2.0 / (ld.k0 * ld.w0 ** 2)
    inv_w2 = 1.0 / (ld.w0 ** 2 * diffract)
    stc = ld.a0 / diffract * math.exp(-(zs * zs) / (ld.L0 ** 2))
    env = stc * torch.exp(-(xs * xs + ys * ys) * inv_w2)
    out = torch.zeros((NY, NX), dtype=env.dtype, device=device)
    out[G:NY - G, G:NX - G] = env[G:NY - G, G:NX - G]
    return out


def on_axis_phase(a, dk: qsa.Deck):
    """The mean on-axis phase, odd sizes (fields/laser.py on_axis_phase;
    ref MultiLaser.cpp:470-515)."""
    G = dk.guards
    return torch.angle(a[(dk.ny + 1) // 2 + G, (dk.nx + 1) // 2 + G])


def _wrap(d):
    d = torch.where(d < -1.5 * math.pi, d + 2.0 * math.pi, d)
    return torch.where(d > 1.5 * math.pi, d - 2.0 * math.pi, d)


def lap_tr(a, dk: qsa.Deck):
    """The transverse Laplacian, zero on and outside the valid box's edge
    (fields/laser.py LaserAdvance.lap_tr)."""
    G = dk.guards
    NY, NX = dk.shape
    y0, y1, x0, x1 = G + 1, NY - G - 1, G + 1, NX - G - 1
    c = a[y0:y1, x0:x1]
    lap = ((a[y0:y1, x0 + 1:x1 + 1] + a[y0:y1, x0 - 1:x1 - 1] - 2 * c)
           / (dk.d(0) ** 2)
           + (a[y0 + 1:y1 + 1, x0:x1] + a[y0 - 1:y1 - 1, x0:x1] - 2 * c)
           / (dk.d(1) ** 2))
    out = torch.zeros_like(a)
    out[y0:y1, x0:x1] = lap
    return out


class ComplexMultiGrid(qsa.MultiGrid):
    """Laplacian(u) - acf u = rhs for a complex u, acf a real plane plus an
    imaginary scalar (fields/multigrid.py solve_plain's complex path, hpmg
    solve2; ref MultiLaser.cpp:430-607): the same V-cycles as the real
    solver, in complex arithmetic, the transfers applied to the real and
    the imaginary part alike; the residual's max-norm is its modulus."""

    @staticmethod
    def _transfer(a, u, b):
        return torch.complex(a @ u.real @ b, a @ u.imag @ b)

    def _vcycle(self, u, rhs, coefs, lev):
        dma, inv = coefs[lev]
        u = self._smooth(u, rhs, inv, lev, 2)
        if lev + 1 < len(self.shapes):
            res = rhs - (self._off(u, lev) + dma * u)
            ry, rx = self.R[lev]
            crhs = self._transfer(ry, res, rx.T)
            cu = self._vcycle(torch.zeros_like(crhs), crhs, coefs, lev + 1)
            u = u + self._transfer((2.0 * ry).T, cu, 2.0 * rx)
            u = self._smooth(u, rhs, inv, lev, 2)
        else:
            u = self._smooth(u, rhs, inv, lev, 8)
        return u

    def solve(self, u0, rhs, acf, tol_rel, max_iters):
        plane, imag = acf
        planes = [plane]
        for lev in range(len(self.shapes) - 1):
            ry, rx = self.R[lev]
            planes.append((ry @ planes[-1] @ rx.T) / self.den[lev])
        coefs = []
        for lev, a in enumerate(planes):
            fx, fy = self.facs[lev]
            dma = torch.complex(-2.0 * (fx + fy) - a,
                                torch.full_like(a, -imag))
            coefs.append((dma, 1.0 / dma))

        def resnorm(u):
            r = rhs - (self._off(u, 0) + coefs[0][0] * u)
            return float(torch.max(torch.abs(r)))

        res = resnorm(u0)
        t = max(tol_rel, 1e-16) * max(res, float(torch.max(torch.abs(rhs))))
        target = float(torch.tensor(t, dtype=plane.dtype))
        u, it = u0, 0
        while res > target and it < max_iters:
            u = self._vcycle(u, rhs, coefs, 0)
            res = resnorm(u)
            it += 1
        self.cycles = it
        return u


STATE = ("n00jp1", "n00jp2", "nm1jp1", "nm1jp2", "np1jp1", "np1jp2")


def advance(ld: LaserDeck, mg: ComplexMultiGrid, st: dict, n00, nm1, chi,
            step: int):
    """np1, the slice's envelope at the next step (fields/laser.py
    LaserAdvance.__call__, the multigrid solver with the on-axis phase and
    the averaged rhs; ref MultiLaser.cpp:430-607 AdvanceSliceMG); st holds
    the slices before: n00, nm1 and np1 one (jp1) and two (jp2) back. Step
    0 takes the non-centred first-step form."""
    dk = ld.dk
    dt, dz, k0 = dk.dt, dk.d(2), ld.k0
    tj00 = on_axis_phase(n00, dk)
    tjp1 = on_axis_phase(st["n00jp1"], dk)
    tjp2 = on_axis_phase(st["n00jp2"], dk)
    exp1 = torch.exp(1j * (tj00 - tjp1))
    exp2 = torch.exp(1j * (tj00 - tjp2))
    djn = (-3.0 * _wrap(tj00 - tjp1) + _wrap(tjp1 - tjp2)) / (2.0 * dz)
    if step == 0:
        acoeff_r = 6.0 / (dt * dz)
        acoeff_i = -4.0 * (k0 + djn) / dt
        rhs = (8.0 / (dt * dz) * (st["n00jp1"] - st["np1jp1"]) * exp1
               + 2.0 / (dt * dz) * (st["np1jp2"] - st["n00jp2"]) * exp2
               - lap_tr(n00, dk)
               + (-6.0 / (dt * dz) + 4.0j * djn / dt + 4.0j * k0 / dt)
               * n00)
        rhs = rhs + chi * n00
    else:
        acoeff_r = 3.0 / (dt * dz) + 2.0 / (dt * dt)
        acoeff_i = -2.0 * (k0 + djn) / dt
        rhs = (4.0 / (dt * dz) * (st["nm1jp1"] - st["np1jp1"]) * exp1
               + 1.0 / (dt * dz) * (st["np1jp2"] - st["nm1jp2"]) * exp2
               - 4.0 / (dt * dt) * n00
               - lap_tr(nm1, dk)
               + (-3.0 / (dt * dz) + 2.0j * djn / dt + 2.0 / (dt * dt)
                  + 2.0j * k0 / dt) * nm1)
        rhs = rhs + chi * nm1
    sol = mg.solve(qsa.interior(st["np1jp1"], dk), qsa.interior(rhs, dk),
                   (acoeff_r + qsa.interior(chi, dk), float(acoeff_i)),
                   ld.mg_tol_rel, ld.mg_max_iters)
    return qsa.set_interior(torch.zeros_like(rhs), sol, dk)


# ------------------------------------------------------ the |a|^2 gather
def gather_aabs(x, y, aabs, dk: qsa.Deck):
    """|a|^2 and its centred derivatives at the lanes, order 2
    (ops/gather.py gather_laser_aabs; ref FieldGather.H:236-280): each lane
    reads the 5 x 5 block around its stencil, rows clipped to the plane,
    the block's first column clipped so that it fits."""
    G = dk.guards
    NY, NX = aabs.shape
    dx_inv, dy_inv = 1.0 / dk.d(0), 1.0 / dk.d(1)
    offs3 = torch.arange(3, device=x.device)
    offs5 = torch.arange(5, device=x.device)

    def axis(pos):
        i0 = qsa.leftmost2(pos)
        return i0, qsa.bspline2(pos[:, None] - (i0[:, None] + offs3)
                                .to(pos.dtype))

    ix0, wx = axis((x - (dk.prob_lo[0] + 0.5 * dk.d(0))) * dx_inv)
    iy0, wy = axis((y - (dk.prob_lo[1] + 0.5 * dk.d(1))) * dy_inv)
    rows = (iy0[:, None] - 1 + G + offs5).clamp(0, NY - 1)
    cols = (ix0 - 1 + G).clamp(0, NX - 5)[:, None] + offs5
    block = aabs.reshape(NY * NX)[rows[:, :, None] * NX + cols[:, None, :]]
    w = wy[:, :, None] * wx[:, None, :]
    a_v = (w * block[:, 1:4, 1:4]).sum(dim=(1, 2))
    adx = (w * 0.5 * dx_inv * (block[:, 1:4, 2:5] - block[:, 1:4, 0:3])
           ).sum(dim=(1, 2))
    ady = (w * 0.5 * dy_inv * (block[:, 2:5, 1:4] - block[:, 0:3, 1:4])
           ).sum(dim=(1, 2))
    return a_v, adx, ady


def _blocks(n: int):
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


# ----------------------------------------------------------------- plasma
def fused_deposit(p, this, dk: qsa.Deck):
    """The explicit solver's plasma deposit with the Sx/Sy coefficient
    channels and the laser's sixth, derivative type 2, |a|^2 in gamma
    (particles/plasma.py fused_plasma_deposits with use_laser); returns
    (this, p, (d1, d2, d3)), d1 of six channels."""
    comps = ("jx", "jy", "chi", "rhomjz")
    acc = torch.cat([torch.stack([this[c] for c in comps]),
                     torch.zeros((10,) + dk.shape, dtype=p["x"].dtype,
                                 device=p["x"].device)])
    new_w, new_valid = [], []
    for b in _blocks(p["x"].numel()):
        q = {k: v[b] for k, v in p.items()}
        a2 = gather_aabs(q["x"], q["y"], this["aabs"], dk)[0]
        psi_inv = 1.0 / q["psi"]
        vx, vy = q["ux"] * psi_inv, q["uy"] * psi_inv
        gp = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv + vx * vx
                    + vy * vy + 1.0)
        bad = ((gp < 0.0) | (gp > dk.max_qsa_weighting_factor)
               | (psi_inv < 0.0))
        wmask = (q["valid"] & ~bad).to(psi_inv.dtype)
        qv = -q["w"] * wmask
        vals = [qv * vx, qv * vy, qv * -1.0 * psi_inv, qv]
        base = qv * -psi_inv
        chans = [base * vx, base * vy, base * vx * vy,
                 base * (gp - vy * vy), base * (gp - vx * vx),
                 0.25 * base * -psi_inv]
        v2 = [qv / dk.d(0) * vx * vy, qv / dk.d(0) * (gp - vx * vx - 1.0)]
        v3 = [-qv / dk.d(1) * (gp - vy * vy - 1.0), -qv / dk.d(1) * vx * vy]
        ym, xm = qsa.cell_positions(q["x"], q["y"], q["valid"], dk)
        qsa.deposit(acc, ym, xm, torch.stack(vals + chans + v2 + v3),
                    deriv=True)
        new_w.append(q["w"] * wmask)
        new_valid.append(q["valid"] & ~bad)
    out = dict(this)
    out.update(zip(comps, acc[:4]))
    p = dict(p, w=torch.cat(new_w), valid=torch.cat(new_valid))
    return out, p, (acc[4:10], acc[10:12], acc[12:14])


def combine_sxsy(this, dgrids, dk: qsa.Deck):
    """Sx/Sy from the coefficient grids, with the laser's channel on the
    clamped-edge centred differences of |a|^2 (particles/plasma.py
    combine_explicit_sxsy)."""
    d1, d2, d3 = dgrids
    out = qsa.combine_sxsy(this, (d1[:5], d2, d3))
    aab = this["aabs"]
    a2dx = (torch.cat([aab[:, 1:], aab[:, -1:]], dim=1)
            - torch.cat([aab[:, :1], aab[:, :-1]], dim=1)) * (0.5 / dk.d(0))
    a2dy = (torch.cat([aab[1:, :], aab[-1:, :]], dim=0)
            - torch.cat([aab[:1, :], aab[:-1, :]], dim=0)) * (0.5 / dk.d(1))
    out["Sy"] = out["Sy"] + a2dy * d1[5]
    out["Sx"] = out["Sx"] - a2dx * d1[5]
    return out


def _dmom(ux, uy, psi_inv, f, lz):
    """PlasmaMomentumPush for charge -1, mass 1, c = 1 with the laser's
    ponderomotive terms lz = (|a|^2 / 2, d|a|^2/dx / 4, d|a|^2/dy / 4)
    (particles/plasma.py _momentum_derivative)."""
    exmby, eypbx, ez, bx, by, bz = f
    gp = 0.5 * psi_inv * psi_inv * (1.0 + lz[0] + ux * ux + uy * uy) + 0.5
    return (-(gp * exmby + by + uy * bz * psi_inv) - lz[1] * psi_inv,
            -(gp * eypbx - bx - ux * bz * psi_inv) - lz[2] * psi_inv,
            -((ux * exmby + uy * eypbx) * psi_inv - ez))


def _dmom_jvp(ux, uy, psi, dux, duy, dpsi, f, lz):
    """The directional derivative of _dmom (particles/plasma.py
    _momentum_derivative_jvp)."""
    exmby, eypbx, ez, bx, by, bz = f
    pi = 1.0 / psi
    dpi = -pi * pi * dpsi
    s = 1.0 + lz[0] + ux * ux + uy * uy
    ds = 2.0 * (ux * dux + uy * duy)
    dg = pi * dpi * s + 0.5 * pi * pi * ds
    return (-(dg * exmby + bz * (duy * pi + uy * dpi)) - lz[1] * dpi,
            -(dg * eypbx - bz * (dux * pi + ux * dpi)) - lz[2] * dpi,
            -((dux * exmby + duy * eypbx) * pi + (ux * exmby + uy * eypbx)
              * dpi))


def _substep(ux, uy, psi, sdz, f, lz):
    d = _dmom(ux, uy, 1.0 / psi, f, lz)
    d2 = _dmom_jvp(ux, uy, psi, *d, f, lz)
    h = 0.5 * sdz * sdz
    return (ux + sdz * d[0] + h * d2[0], uy + sdz * d[1] + h * d2[1],
            psi + sdz * d[2] + h * d2[2])


def push_plasma(p, this, dk: qsa.Deck):
    """The leapfrog push to the next slice with the laser's terms gathered
    at the lanes' previous positions (particles/plasma.py advance_plasma,
    one subcycle, use_laser)."""
    dz = dk.d(2)
    sdz = dz / 4
    out = {k: [] for k in ("x", "y", "ux", "uy", "psi", "ux_half",
                           "uy_half", "psi_half")}
    for b in _blocks(p["x"].numel()):
        q = {k: v[b] for k, v in p.items()}
        f = qsa.gather_fields(this, q["x_prev"], q["y_prev"], q["valid"], dk)
        a2, adx, ady = gather_aabs(q["x_prev"], q["y_prev"], this["aabs"], dk)
        lz = (a2 * 0.5, adx * 0.25, ady * 0.25)
        ux, uy, psi = q["ux_half"], q["uy_half"], q["psi_half"]
        for _ in range(4):
            ux, uy, psi = _substep(ux, uy, psi, sdz, f, lz)
        x, y = qsa.periodic(q["x_prev"] + dz * ux / psi,
                            q["y_prev"] + dz * uy / psi, dk)
        out["ux_half"].append(ux)
        out["uy_half"].append(uy)
        out["psi_half"].append(psi)
        for _ in range(2):
            ux, uy, psi = _substep(ux, uy, psi, sdz, f, lz)
        for k, v in (("x", x), ("y", y), ("ux", ux), ("uy", uy),
                     ("psi", psi)):
            out[k].append(v)
    new = dict(p)
    new.update((k, torch.cat(v)) for k, v in out.items())
    new.update(x_prev=new["x"], y_prev=new["y"])
    return new


# ------------------------------------------------------------- the step
class Step(qsa.Step):
    """One time step of the deck (pipeline/simulation.py _time_step and
    pipeline/step.py SliceStep with a laser and no beam): the plasma and
    its neutralizing background anew, the sweep from the head slice to the
    tail. ``run`` yields, per slice in sweep order, (islice, the slice's
    fields by name, the slice's advanced envelope np1)."""

    def __init__(self, ld: LaserDeck, device, dtype):
        super().__init__(ld.dk, device, dtype)
        self.ld = ld
        self.cmg = ComplexMultiGrid(ld.dk, device, dtype)
        # the field's chi is trusted two guard widths inside the edge;
        # outside, chi of the density profile
        G2 = 2 * ld.dk.guards
        NY, NX = ld.dk.shape
        self.trust = torch.zeros((NY, NX), dtype=torch.bool, device=device)
        self.trust[G2:NY - G2, G2:NX - G2] = True
        self.chi0 = torch.full((NY, NX), ld.dk.plasma_density, dtype=dtype,
                               device=device)
        self.laser_cycles = []

    def run(self, stream, step: int, plasma=None):
        """The step from the envelope stream (n00, nm1), complex (nz, NY,
        NX) rows at the step's start (unread at step 0 but for nm1: the
        initial envelope stands in for n00), and the plasma's lanes at the
        step's start (the cold lattice where None)."""
        dk = self.dk
        if plasma is None:
            plasma = qsa.init_plasma(dk, self.device, self.dtype)
        ions, _ = qsa.deposit_plasma(plasma, self.zeros("rhomjz"),
                                     ["rhomjz"], dk, flip=True)
        ions = ions["rhomjz"]
        f = {"This": self.zeros("chi", "Sy", "Sx", "ExmBy", "EypBx", "Ez",
                                "Bx", "By", "Bz", "Psi", "jx_beam", "jy_beam",
                                "jz_beam", "jx", "jy", "rhomjz", "aabs"),
             "Next": self.zeros("jx_beam", "jy_beam"),
             "Previous": self.zeros("jx_beam", "jy_beam")}
        zero = torch.zeros(dk.shape, dtype=stream[0].dtype,
                           device=self.device)
        lstate = {k: zero for k in STATE}
        self.cycles, self.laser_cycles = [], []
        for islice in range(dk.nz - 1, -1, -1):
            n00 = (envelope_slice(self.ld, islice, self.dtype, self.device)
                   if step == 0 else stream[0][islice].to(self.device))
            nm1 = stream[1][islice].to(self.device)
            f, plasma, this, np1 = self._slice(f, plasma, ions, n00, nm1,
                                               lstate, step)
            yield islice, this, np1
            lstate = {"n00jp1": n00, "n00jp2": lstate["n00jp1"],
                      "nm1jp1": nm1, "nm1jp2": lstate["nm1jp1"],
                      "np1jp1": np1, "np1jp2": lstate["np1jp1"]}

    def _slice(self, f, plasma, ions, n00, nm1, lstate, step):
        dk = self.dk
        this = dict(f["This"])
        for c in ("chi", "Sy", "Sx", "ExmBy", "EypBx", "jz_beam", "rhomjz"):
            this[c] = torch.zeros_like(this[c])
        nxt = {c: torch.zeros_like(v) for c, v in f["Next"].items()}
        this["aabs"] = torch.abs(n00) ** 2
        this, plasma, dgrids = fused_deposit(plasma, this, dk)
        this["rhomjz"] = this["rhomjz"] + ions
        this = self._psi_ez_bz(this)
        chi = torch.where(self.trust, this["chi"], self.chi0)
        np1 = advance(self.ld, self.cmg, lstate, n00, nm1, chi, step)
        self.laser_cycles.append(self.cmg.cycles)
        dz2 = 1.0 / (2.0 * dk.d(2))
        prev = f["Previous"]
        this["Sy"] = qsa.set_interior(
            this["Sy"], -qsa.ddy(this["jz_beam"], dk)
            + (qsa.interior(prev["jy_beam"], dk)
               - qsa.interior(nxt["jy_beam"], dk)) * dz2, dk)
        this["Sx"] = qsa.set_interior(
            this["Sx"], qsa.ddx(this["jz_beam"], dk)
            - (qsa.interior(prev["jx_beam"], dk)
               - qsa.interior(nxt["jx_beam"], dk)) * dz2, dk)
        this = combine_sxsy(this, dgrids, dk)
        b0 = torch.stack([qsa.interior(this["Bx"], dk),
                          qsa.interior(this["By"], dk)])
        b = self.mg.solve(b0, torch.stack([qsa.interior(this["Sy"], dk),
                                           qsa.interior(this["Sx"], dk)]),
                          qsa.interior(this["chi"], dk), dk.mg_tol_rel,
                          dk.mg_max_iters)
        this["Bx"] = qsa.set_interior(this["Bx"], b[0], dk)
        this["By"] = qsa.set_interior(this["By"], b[1], dk)
        self.cycles.append(self.mg.cycles)
        plasma = push_plasma(plasma, this, dk)
        new_this = dict(this)
        for c in ("jx", "jy"):
            new_this[f"{c}_beam"] = nxt[f"{c}_beam"]
            new_this[c] = nxt[f"{c}_beam"]
        f = {"This": new_this, "Next": nxt,
             "Previous": {"jx_beam": this["jx_beam"],
                          "jy_beam": this["jy_beam"]}}
        return f, plasma, this, np1
