"""Laser envelope solver (Benedetti 2017 / Wake-T scheme).

Port of ``hipace_tpu/fields/laser.py`` (ref MultiLaser.{H,cpp},
Laser.{H,cpp}): the complex envelope A(x, y, zeta) advances one time step
per slice by a 2-D complex Helmholtz solve

    (Laplacian_perp - a) A^{n+1}_j = rhs(A^n, A^{n-1}, neighbours, chi)

with the complex multigrid (hpmg solve2, ref MultiLaser.cpp:430-607; on the
card K3's complex path) or a periodic-FFT spectral solve (ref
MultiLaser.cpp:610-780; ``torch.fft``). The on-axis phase and the djn
phase-advance term follow MultiLaser.cpp:470-529; they stay 0-d device
tensors, and the first-step variant is chosen by the host-known step index,
so the advance reads nothing back.

The state of a slice (the reference's 18-component slice fab, ref
MultiLaser.H:23-49) is a dict of complex (NY, NX) tensors: n00j00 and
nm1j00 streamed between steps, n00jp1/jp2, nm1jp1/jp2 and np1jp1/jp2
carried from slice to slice; the advance returns np1j00, the next step's
n00.

A from-file envelope (openPMD / lasy layouts xyt, xyz and rt, ref
Laser.cpp:119-330) is read with h5py; where h5py does not import, a
from-file deck raises when the simulation is built.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import PhysConst
from ..geometry import Geometry
from ..parser import Inputs, TorchFunction
from . import slices as sl
from .multigrid import MultiGrid, complex_dtype


@dataclasses.dataclass(frozen=True)
class LaserPulseConfig:
    """One pulse (ref Laser.{H,cpp}): gaussian, parsed or from a file."""
    init_type: str = "gaussian"
    a0: float = 0.0
    w0: float = 0.0
    L0: float = 0.0
    CEP: float = 0.0
    focal_distance: float = 0.0
    position_mean: tuple = (0.0, 0.0, 0.0)
    propagation_angle_yz: float = 0.0
    # pi/2 makes the (pft - pi/2) rotation the identity (ref Laser.H:39)
    PFT_yz: float = math.pi / 2.0
    profile_real_expr: str = "0"
    profile_imag_expr: str = "0"
    consts: tuple = ()
    # from_file init (ref Laser.H:53-62, Laser.cpp:22-30)
    input_file: str = ""
    file_envelope_name: str = "laserEnvelope"
    file_iteration: int = 0

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst):
        pp = inputs.prefix(name)
        init_type = pp.query("init_type", "gaussian", str)
        L0 = pp.query("L0", 0.0)
        if pp.contains("tau"):
            L0 = pp.get("tau") * pc.c
        pr, pi = "0", "0"
        f = pp.get_function("laser_real", ("x", "y", "z"))
        if f is not None:
            pr = f.expr
            if pp.query("init_type", "", str) == "":
                init_type = "parser"
        f = pp.get_function("laser_imag", ("x", "y", "z"))
        if f is not None:
            pi = f.expr
        return cls(
            init_type=init_type,
            a0=pp.query("a0", 0.0),
            w0=pp.query("w0", 0.0),
            L0=L0,
            CEP=pp.query("CEP", 0.0),
            focal_distance=pp.query("focal_distance", 0.0),
            position_mean=tuple(pp.query_list("position_mean", [0., 0., 0.])),
            propagation_angle_yz=pp.query("propagation_angle_yz", 0.0),
            PFT_yz=pp.query("PFT_yz", math.pi / 2.0),
            input_file=pp.query("input_file", "", str),
            file_envelope_name=pp.query("openPMD_laser_name",
                                        "laserEnvelope", str),
            file_iteration=pp.query("iteration", 0, int),
            profile_real_expr=pr, profile_imag_expr=pi,
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
        )


@dataclasses.dataclass(frozen=True)
class LaserConfig:
    """The laser subsystem (ref MultiLaser::ReadParameters): the pulses,
    summed into one envelope, and the solver."""
    pulses: tuple = ()
    lambda0: float = 0.8e-6
    solver_type: str = "multigrid"      # "multigrid" | "fft"
    use_phase: bool = True
    interp_order: int = 1   # laser <-> field grid interpolation (ref :40)
    MG_tolerance_rel: float = 1e-4
    MG_tolerance_abs: float = 0.0
    MG_average_rhs: bool = True

    @classmethod
    def from_inputs(cls, inputs: Inputs, pc: PhysConst):
        names = inputs.query_list("lasers.names", [], str)
        if names == ["no_laser"]:
            names = []
        pp = inputs.prefix("lasers")
        cfg = cls(
            pulses=tuple(LaserPulseConfig.from_inputs(inputs, n, pc)
                         for n in names),
            lambda0=pp.query("lambda0", 0.8e-6),
            solver_type=pp.query("solver_type", "multigrid", str),
            use_phase=pp.query("use_phase", True, bool),
            interp_order=pp.query("interp_order", 1, int),
            MG_tolerance_rel=pp.query("MG_tolerance_rel", 1e-4),
            MG_tolerance_abs=pp.query("MG_tolerance_abs", 0.0),
            MG_average_rhs=pp.query("MG_average_rhs", True, bool),
        )
        if cfg.solver_type not in ("multigrid", "fft"):
            raise ValueError(f"lasers.solver_type = {cfg.solver_type}: "
                             "multigrid or fft")
        return cfg

    @property
    def use_laser(self) -> bool:
        return len(self.pulses) > 0

    @property
    def from_file(self) -> bool:
        return any(p.init_type == "from_file" for p in self.pulses)


def make_laser_geometry(inputs: Inputs, geom0: Geometry):
    """The laser's own geometry (ref MultiLaser::MakeLaserGeometry,
    MultiLaser.cpp:59-110): lasers.n_cell / patch_lo / patch_hi, by default
    the field geometry; zeta snaps to field slices. Returns (Geometry,
    zeta_lo, zeta_hi)."""
    pp = inputs.prefix("lasers")
    n_cell = pp.query_list("n_cell", [geom0.nx, geom0.ny], int)
    patch_lo = pp.query_list("patch_lo", list(geom0.prob_lo))
    patch_hi = pp.query_list("patch_hi", list(geom0.prob_hi))
    poff_z = geom0.z_pos_offset
    zeta_lo = max(0, round((patch_lo[2] - poff_z) / geom0.dz))
    zeta_hi = min(geom0.nz - 1, round((patch_hi[2] - poff_z) / geom0.dz))
    lo_z = (zeta_lo - 0.5) * geom0.dz + poff_z
    hi_z = (zeta_hi + 0.5) * geom0.dz + poff_z
    # the field geometry itself where they coincide (no round-off from a
    # rebuilt z range, and no interpolation)
    tol = 1e-12 * max(abs(geom0.prob_hi[0] - geom0.prob_lo[0]), 1e-300)
    if (tuple(n_cell) == (geom0.nx, geom0.ny)
            and zeta_lo == 0 and zeta_hi == geom0.nz - 1
            and all(abs(patch_lo[d] - geom0.prob_lo[d]) < tol
                    and abs(patch_hi[d] - geom0.prob_hi[d]) < tol
                    for d in (0, 1))):
        return geom0, 0, geom0.nz - 1
    g = Geometry(
        n_cell=(int(n_cell[0]), int(n_cell[1]), zeta_hi - zeta_lo + 1),
        prob_lo=(patch_lo[0], patch_lo[1], lo_z),
        prob_hi=(patch_hi[0], patch_hi[1], hi_z),
        nguards=geom0.nguards, is_periodic=(False, False, False))
    return g, zeta_lo, zeta_hi


def _cell_xy(geom: Geometry, dtype, device):
    """Cell-centre x (1, NX) and y (NY, 1) of the padded slice."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    kw = dict(dtype=dtype, device=device)
    x = (torch.arange(NX, **kw) - G + 0.5) * geom.dx + geom.prob_lo[0]
    y = (torch.arange(NY, **kw) - G + 0.5) * geom.dy + geom.prob_lo[1]
    return x[None, :], y[:, None]


def envelope_slice(lcfg: LaserConfig, geom: Geometry, z: float, dtype,
                   device=None) -> torch.Tensor:
    """The initial envelope A0 at zeta position z, all analytic pulses
    summed (ref MultiLaser.cpp:804-920 InitLaserSlice), complex (NY, NX)
    with zero guard cells; geom is the laser geometry."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    k0 = 2.0 * math.pi / lcfg.lambda0
    X, Y = _cell_xy(geom, dtype, device)
    ctype = complex_dtype(dtype)
    env = torch.zeros((NY, NX), dtype=ctype, device=device)
    for p in lcfg.pulses:
        if p.init_type == "gaussian":
            x0, y0, z0 = p.position_mean
            ang = p.propagation_angle_yz
            pft = p.PFT_yz - math.pi / 2.0
            xs = X - x0
            ys = Y - y0
            zs = z - z0
            yp = math.cos(ang + pft) * ys - math.sin(ang + pft) * zs
            zp = math.sin(ang + pft) * ys + math.cos(ang + pft) * zs
            diffract = 1.0 + 1j * (zp - p.focal_distance + z0 * math.cos(
                ang)) * 2.0 / (k0 * p.w0 ** 2)
            inv_w2 = 1.0 / (p.w0 ** 2 * diffract)
            pref = p.a0 / diffract
            stc = pref * torch.exp(-(zp * zp) / (p.L0 ** 2))
            # the carrier-envelope phase enters as a real exponent, as the
            # JAX package writes it
            envp = (stc * torch.exp(-(xs * xs + yp * yp) * inv_w2)
                    * torch.exp(1j * (yp * k0 * ang) + p.CEP))
            env = env + envp.to(ctype)
        elif p.init_type == "parser":
            consts = dict(p.consts)
            Xb = torch.broadcast_to(X, (NY, NX))
            Yb = torch.broadcast_to(Y, (NY, NX))
            zz = torch.full((NY, NX), z, dtype=dtype, device=device)
            fr = TorchFunction(p.profile_real_expr, ("x", "y", "z"), consts)
            fi = TorchFunction(p.profile_imag_expr, ("x", "y", "z"), consts)
            env = env + torch.complex(fr(Xb, Yb, zz), fi(Xb, Yb, zz))
    # zero guard cells, like the reference's tilebox fill
    out = torch.zeros_like(env)
    out[G:NY - G, G:NX - G] = env[G:NY - G, G:NX - G]
    return out


def initial_chi(plasma_cfgs, geom: Geometry, pc: PhysConst, c_t: float,
                dtype, device=None) -> torch.Tensor:
    """chi from the plasmas' density functions (ref
    MultiLaser.cpp:294-331), real (NY, NX)."""
    NY, NX = geom.slice_shape
    X, Y = _cell_xy(geom, dtype, device)
    X = torch.broadcast_to(X, (NY, NX))
    Y = torch.broadcast_to(Y, (NY, NX))
    chi = torch.zeros((NY, NX), dtype=dtype, device=device)
    for pcfg in plasma_cfgs:
        fac = pcfg.charge ** 2 * pc.mu0 / pcfg.mass
        if pcfg.can_ionize:
            # the starting level's square on a charge it already multiplied
            # (ROADMAP R16); 0 for a neutral gas
            fac *= pcfg.init_ion_lev ** 2
        dens = pcfg.density_fn()(X, Y, torch.full_like(X, c_t))
        chi = chi + dens * fac
    return chi


def on_axis_phase(a: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """The mean on-axis phase (ref MultiLaser.cpp:470-515): the argument of
    the central cell(s)' sum, a 0-d tensor."""
    G = geom.nguards
    imid = (geom.nx + 1) // 2 + G
    jmid = (geom.ny + 1) // 2 + G
    ax = a[..., imid - 1] + a[..., imid] if geom.nx % 2 == 0 \
        else a[..., imid]
    v = ax[..., jmid - 1] + ax[..., jmid] if geom.ny % 2 == 0 \
        else ax[..., jmid]
    return torch.atan2(v.imag, v.real)


def _wrap(d):
    """A phase difference brought into [-1.5 pi, 1.5 pi] by one turn."""
    two_pi = 2.0 * math.pi
    d = torch.where(d < -1.5 * math.pi, d + two_pi, d)
    return torch.where(d > 1.5 * math.pi, d - two_pi, d)


class LaserAdvance:
    """The per-slice envelope advance (AdvanceSliceMG, ref
    MultiLaser.cpp:430-607, and AdvanceSliceFFT, :610-780) on the laser
    geometry; holds the solver. ``mg`` is the complex multigrid (None with
    the FFT solver)."""

    def __init__(self, lcfg: LaserConfig, geom: Geometry, pc: PhysConst,
                 device=None, dtype=torch.float64):
        self.lcfg, self.geom, self.pc = lcfg, geom, pc
        self.mg = (MultiGrid(geom.nx, geom.ny, geom.dx, geom.dy,
                             device=device, dtype=dtype)
                   if lcfg.solver_type == "multigrid" else None)
        if lcfg.solver_type == "fft":
            kx = 2.0 * math.pi * torch.fft.fftfreq(
                geom.nx, d=geom.dx, dtype=torch.float64).to(dtype)
            ky = 2.0 * math.pi * torch.fft.fftfreq(
                geom.ny, d=geom.dy, dtype=torch.float64).to(dtype)
            self.k2 = (kx[None, :] ** 2 + ky[:, None] ** 2).to(device)
        else:
            self.k2 = None
        # the transverse Laplacian's region: inside the valid box's edge
        G = geom.nguards
        NY, NX = geom.slice_shape
        self.lap_box = (slice(G + 1, NY - G - 1), slice(G + 1, NX - G - 1))

    def lap_tr(self, a):
        """Transverse Laplacian, zero on and outside the valid box's edge
        (ref MultiLaser.cpp lapR/lapI edge guard)."""
        dx, dy = self.geom.dx, self.geom.dy
        by, bx = self.lap_box
        c = a[by, bx]
        lap = ((a[by, bx.start + 1:bx.stop + 1] + a[by, bx.start - 1:bx.stop - 1]
                - 2 * c) / (dx * dx)
               + (a[by.start + 1:by.stop + 1, bx] + a[by.start - 1:by.stop - 1, bx]
                  - 2 * c) / (dy * dy))
        out = torch.zeros_like(a)
        out[by, bx] = lap
        return out

    def __call__(self, state: dict, chi: torch.Tensor, dt: float,
                 step: int) -> torch.Tensor:
        """np1j00 from the slice state (complex (NY, NX) n00j00, n00jp1,
        n00jp2, nm1j00, nm1jp1, nm1jp2, np1jp1, np1jp2) and chi (real
        (NY, NX)); step 0 takes the non-centred first-step variant."""
        lcfg, g = self.lcfg, self.geom
        c = self.pc.c
        k0 = 2.0 * math.pi / lcfg.lambda0
        dz = g.dz
        n00j00 = state["n00j00"]
        is0 = step == 0

        if lcfg.use_phase:
            tj00 = on_axis_phase(n00j00, g)
            tjp1 = on_axis_phase(state["n00jp1"], g)
            tjp2 = on_axis_phase(state["n00jp2"], g)
            dt1 = _wrap(tj00 - tjp1)
            dt2 = _wrap(tjp1 - tjp2)
            exp1 = torch.exp(1j * (tj00 - tjp1))
            exp2 = torch.exp(1j * (tj00 - tjp2))
            djn = (-3.0 * dt1 + dt2) / (2.0 * dz)
        else:
            exp1 = exp2 = 1.0 + 0j
            djn = 0.0

        if is0:
            acoeff_r = 6.0 / (c * dt * dz)
            acoeff_i = -4.0 * (k0 + djn) / (c * dt)
            lapA = self.lap_tr(n00j00)
            rhs = (8.0 / (c * dt * dz) * (-state["np1jp1"] + state["n00jp1"])
                   * exp1
                   + 2.0 / (c * dt * dz) * (state["np1jp2"] - state["n00jp2"])
                   * exp2
                   - lapA
                   + (-6.0 / (c * dt * dz) + 4.0j * djn / (c * dt)
                      + 4.0j * k0 / (c * dt)) * n00j00)
        else:
            acoeff_r = 3.0 / (c * dt * dz) + 2.0 / (c * c * dt * dt)
            acoeff_i = -2.0 * (k0 + djn) / (c * dt)
            nm1j00 = state["nm1j00"]
            lapA = self.lap_tr(nm1j00)
            rhs = (4.0 / (c * dt * dz) * (-state["np1jp1"] + state["nm1jp1"])
                   * exp1
                   + 1.0 / (c * dt * dz) * (state["np1jp2"] - state["nm1jp2"])
                   * exp2
                   - 4.0 / (c * c * dt * dt) * n00j00
                   - lapA
                   + (-3.0 / (c * dt * dz) + 2.0j * djn / (c * dt)
                      + 2.0 / (c * c * dt * dt) + 2.0j * k0 / (c * dt))
                   * nm1j00)
        if lcfg.solver_type == "multigrid" and lcfg.MG_average_rhs:
            rhs = rhs + chi * (n00j00 if is0 else state["nm1j00"])
        else:
            rhs = rhs + 2.0 * chi * n00j00

        if lcfg.solver_type == "fft":
            # spectral solve with the periodic Laplacian's eigenvalues
            # -(kx^2 + ky^2) (ref MultiLaser.cpp:758-780)
            acoeff = acoeff_r + 1j * acoeff_i
            spec = torch.fft.fft2(sl.interior(rhs, g))
            sol = torch.fft.ifft2(spec * (-1.0 / (self.k2 + acoeff)))
        else:
            # the complex multigrid, hpmg solve2: acf = a real plane plus
            # the imaginary scalar i acoeff_i, a 0-d device tensor
            chi_i = sl.interior(chi, g)
            acf_r = (acoeff_r + chi_i if lcfg.MG_average_rhs
                     else torch.full_like(chi_i, acoeff_r))
            if torch.is_tensor(acoeff_i):
                s = torch.complex(torch.zeros_like(acoeff_i), acoeff_i)
            else:
                s = complex(0.0, acoeff_i)
            sol = self.mg.solve(sl.interior(state["np1jp1"], g),
                                sl.interior(rhs, g), (acf_r, s),
                                tol_rel=lcfg.MG_tolerance_rel,
                                tol_abs=lcfg.MG_tolerance_abs, max_iters=40)
        return sl.set_interior(torch.zeros_like(rhs), sol, g)


def make_laser_advance(lcfg: LaserConfig, geom: Geometry, pc: PhysConst,
                       dtype=torch.float64, device=None) -> LaserAdvance:
    """The per-slice advance: advance(state, chi, dt, step) -> np1j00."""
    return LaserAdvance(lcfg, geom, pc, device=device, dtype=dtype)


STATE_KEYS = ("n00j00", "n00jp1", "n00jp2", "nm1j00", "nm1jp1", "nm1jp2",
              "np1jp1", "np1jp2")


def laser_empty_state(geom: Geometry, dtype, device=None) -> dict:
    z = torch.zeros(geom.slice_shape, dtype=complex_dtype(dtype),
                    device=device)
    return {k: z for k in STATE_KEYS}


def shift_laser_slices(state: dict, np1j00) -> dict:
    """ShiftLaserSlices (ref MultiLaser.cpp:181-212): this slice's n00, nm1
    and np1 become the next slice's jp1, and the jp1 ones its jp2."""
    return {"n00jp1": state["n00j00"], "n00jp2": state["n00jp1"],
            "nm1jp1": state["nm1j00"], "nm1jp2": state["nm1jp1"],
            "np1jp1": np1j00, "np1jp2": state["np1jp1"],
            "n00j00": state["n00j00"], "nm1j00": state["nm1j00"]}


# ----------------------------------------------------------------------
def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise RuntimeError(
            "a from_file laser envelope is read with h5py, which does not "
            "import here") from err
    return h5py


def _lin_take(arr, axis, idx, w0, w1, n_src):
    """Separable order-1 interpolation along one axis, zero outside the
    source extent (ref ShapeFactors.H compute_shape_factor<1> and the
    bounds checks of Laser.cpp:207-224)."""
    i0 = np.clip(idx, 0, n_src - 1)
    i1 = np.clip(idx + 1, 0, n_src - 1)
    v0 = np.where((idx >= 0) & (idx < n_src), 1.0, 0.0)
    v1 = np.where((idx + 1 >= 0) & (idx + 1 < n_src), 1.0, 0.0)
    a0 = np.take(arr, i0, axis=axis)
    a1 = np.take(arr, i1, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = -1
    return (a0 * (w0 * v0).reshape(shape)
            + a1 * (w1 * v1).reshape(shape))


def _shape1(mid):
    """Floor index and (1 - frac, frac) weights (compute_shape_factor<1>)."""
    idx = np.floor(mid).astype(np.int64)
    frac = mid - idx
    return idx, 1.0 - frac, frac


def read_envelope_file(p: LaserPulseConfig, geom: Geometry,
                       clight: float) -> np.ndarray:
    """One pulse's from_file envelope on the laser grid interior, complex
    (nz, ny, nx) (ref GetEnvelopeFromFile, Laser.cpp:119-330): openPMD /
    lasy layouts xyt (axes t, y, x), xyz (z, y, x) and rt (t, r with
    azimuthal modes), order-1 interpolation onto the grid, unitSI
    scaling."""
    h5py = _h5py()
    name = p.file_envelope_name
    with h5py.File(p.input_file, "r") as f:
        mesh = f[f"data/{p.file_iteration}"]["fields"]
        if name in mesh:
            ds = mesh[name]
        elif f"laser_diag/{name}" in mesh:
            ds = mesh[f"laser_diag/{name}"]
        else:
            raise KeyError(f"{name} not found in {p.input_file}")
        arr = np.asarray(ds)
        labels = [lb.decode() if isinstance(lb, bytes) else str(lb)
                  for lb in ds.attrs.get("axisLabels", [b"z", b"y", b"x"])]
        spacing = np.asarray(ds.attrs.get("gridSpacing",
                                          [geom.dz, geom.dy, geom.dx]),
                             np.float64)
        offset = np.asarray(ds.attrs.get("gridGlobalOffset",
                                         [0.0, 0.0, 0.0]), np.float64)
        position = np.asarray(ds.attrs.get("position", [0.0] * arr.ndim),
                              np.float64)
        unitSI = float(ds.attrs.get("unitSI", 1.0))

    arr = arr.astype(np.complex128) * unitSI
    # the target grid: cell centres of the interior
    x = (np.arange(geom.nx) + 0.5) * geom.dx + geom.prob_lo[0]
    y = (np.arange(geom.ny) + 0.5) * geom.dy + geom.prob_lo[1]
    z = (np.arange(geom.nz) + 0.5) * geom.dz + geom.prob_lo[2]
    zmax = geom.prob_hi[2] - geom.dz / 2

    if labels in (["t", "y", "x"], ["z", "y", "x"]):
        ymin_l = offset[1] + position[1] * spacing[1]
        xmin_l = offset[2] + position[2] * spacing[2]
        ix, wx0, wx1 = _shape1((x - xmin_l) / spacing[2])
        iy, wy0, wy1 = _shape1((y - ymin_l) / spacing[1])
        if labels[0] == "t":
            tmid = (zmax - z) / clight / spacing[0]
        else:
            zmin_l = offset[0] + position[0] * spacing[0]
            tmid = (z - zmin_l) / spacing[0]
        iz, wz0, wz1 = _shape1(tmid)
        out = _lin_take(arr, 2, ix, wx0, wx1, arr.shape[2])
        out = _lin_take(out, 1, iy, wy0, wy1, arr.shape[1])
        return _lin_take(out, 0, iz, wz0, wz1, arr.shape[0])

    if labels == ["t", "r"]:
        # lasy rt: axes (modes, t, r); mode 0, then (cos, sin) pairs (ref
        # Laser.cpp:281-330)
        if arr.ndim == 2:
            arr = arr[None]
        nmodes, nt, nr = arr.shape
        rmin_l = offset[1] + position[1] * spacing[1]
        X, Y = np.meshgrid(x, y)
        r = np.sqrt(X * X + Y * Y)
        theta = np.arctan2(Y, X)
        ir, wr0, wr1 = _shape1((r - rmin_l) / spacing[1])
        it_, wt0, wt1 = _shape1((zmax - z) / clight / spacing[0])
        ir0 = np.clip(ir, 0, nr - 1)
        ir1 = np.clip(ir + 1, 0, nr - 1)
        vr0 = ((ir >= 0) & (ir < nr)).astype(np.float64) * wr0
        vr1 = ((ir + 1 >= 0) & (ir + 1 < nr)).astype(np.float64) * wr1
        rad = arr[:, :, ir0] * vr0 + arr[:, :, ir1] * vr1
        acc = rad[0]
        for m in range(1, (nmodes - 1) // 2 + 1):
            acc = acc + rad[2 * m - 1] * np.cos(m * theta) \
                + rad[2 * m] * np.sin(m * theta)
        it0 = np.clip(it_, 0, nt - 1)
        it1 = np.clip(it_ + 1, 0, nt - 1)
        vt0 = ((it_ >= 0) & (it_ < nt)).astype(np.float64) * wt0
        vt1 = ((it_ + 1 >= 0) & (it_ + 1 < nt)).astype(np.float64) * wt1
        return acc[it0] * vt0[:, None, None] + acc[it1] * vt1[:, None, None]

    raise ValueError(f"unsupported laser file axisLabels {labels} "
                     "(must be t/y/x, z/y/x or t/r)")


def load_laser_from_file(lcfg: LaserConfig, geom: Geometry, dtype,
                         zeta_lo: int = 0, nz_global: int | None = None,
                         clight: float = 1.0, device=None) -> torch.Tensor:
    """The initial envelope stream from openPMD file(s) (ref
    Laser.cpp:19-60 and GetEnvelopeFromFile): every from_file pulse read
    and interpolated onto the laser grid, the analytic pulses of the same
    deck summed in. Indexed by global slice (rows outside the laser's zeta
    range stay zero), guards zero; complex (nz_global, NY, NX) on
    `device`."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    nz_global = geom.nz if nz_global is None else nz_global
    interior = np.zeros((geom.nz, geom.ny, geom.nx), np.complex128)
    analytic = [p for p in lcfg.pulses if p.init_type != "from_file"]
    for p in lcfg.pulses:
        if p.init_type == "from_file":
            interior += read_envelope_file(p, geom, clight)
    if analytic:
        sub = dataclasses.replace(lcfg, pulses=tuple(analytic))
        z = (np.arange(geom.nz) + 0.5) * geom.dz + geom.prob_lo[2]
        rows = [envelope_slice(sub, geom, float(zk), dtype).numpy()
                for zk in z]
        interior += np.stack(rows)[:, G:NY - G, G:NX - G]
    full = np.zeros((nz_global, NY, NX), np.complex128)
    full[zeta_lo:zeta_lo + geom.nz, G:NY - G, G:NX - G] = interior
    return torch.as_tensor(full).to(device=device,
                                    dtype=complex_dtype(dtype))
