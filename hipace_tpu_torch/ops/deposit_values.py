"""The plasma deposit's values: one plasma species' K1 inputs on one slice.

Port of the lane algebra of the JAX package's explicit plasma deposit
(``hipace_tpu/particles/plasma.py`` ``fused_plasma_deposits``, ref
PlasmaDepositCurrent.cpp:22-257 and ExplicitDeposition.cpp), which runs on
XLA before its K1 call, with the |a|^2 gather (``gather_laser_aabs``) that
enters gamma where the deck has a laser.

``deposit_values_plain`` is that algebra in PyTorch on any device: per lane
1/psi, the velocities, gamma psi (with |a|^2 at the lane), the
quasi-static test, the ion levels' factors, the main channels in the row
order of ``stack_comps`` (rho_<species> takes rho's values), the Sx/Sy
coefficient channels and the derivative channels in the order of
``deriv_type``, K1's cell positions and the species' new w and valid.
``deposit_values`` runs a call: CPU tensors take ``deposit_values_plain``,
CUDA tensors launch ``csrc/deposit_values.cu``, which computes every lane's
values in one launch as the plain version does on the card (orders 0-3,
derivative types 0-2, as K1), and counts its launches in
``deposit_values.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import PhysConst
from ..geometry import Geometry
from ..particles import plasma as pl
from ..tracing import span
from . import cuda_lib
from .gather import gather_laser_aabs

# the main channels' value codes (ValueCode in csrc/deposit_values.cu); the
# Sx/Sy coefficient channels are 6-11, the derivative channels v2 12-13 and
# v3 14-15
MAIN_CODES = {"jx": 0, "jy": 1, "jz": 2, "rho": 3, "chi": 4, "rhomjz": 5}
COEFF_CODE, V2_CODE, V3_CODE = 6, 12, 14
# the lanes' attributes the kernel reads, in its order (and valid)
LANE_IN = ("x", "y", "ux", "uy", "psi", "w")
# the kernel's scalars (ValuesParams in csrc/deposit_values.cu), in its order
PARAMS = ("q_invvol", "q_mu0_m", "q_m", "lnorm", "cin", "clight", "cd_mu0",
          "max_qsa", "inv_dx", "inv_dy", "x_off", "y_off", "guards")


def value_codes(stack_comps, deriv_type: int, use_laser: bool) -> list:
    """Each value row's code, row 0 first: the main channels in the order
    of stack_comps, the coefficient channels, then the derivative channels
    v2 and v3 (deriv_type 2) or v3 and v2."""
    main = [MAIN_CODES["rho" if c.startswith("rho_") else c]
            for c in stack_comps]
    coeff = list(range(COEFF_CODE, COEFF_CODE + 5 + int(use_laser)))
    v2, v3 = [V2_CODE, V2_CODE + 1], [V3_CODE, V3_CODE + 1]
    return main + coeff + (v2 + v3 if deriv_type == 2 else v3 + v2)


def deposit_values_plain(p: dict, stack_comps, fields: dict, geom: Geometry,
                         cfg, pc: PhysConst, order: int,
                         normalized_units: bool, deriv_type: int = 2,
                         use_laser: bool = False, extra_mask=None,
                         geom0: Geometry | None = None):
    """The values' plain version (any device), arguments as
    fused_plasma_deposits': (values (C, N) in value_codes' row order, ym,
    xm, the new w, the new valid). With use_laser |a|^2 enters gamma and a
    sixth coefficient channel (q/m)^2 mu0 rho / (4 psi^2) joins the five.
    On a fine level (extra_mask, geom0) only the masked lanes deposit, at
    the level-0 density, and the coefficient channels weigh the masked
    valid lanes without the quasi-static test."""
    charge = cfg.charge
    cin = 1.0 / pc.c
    invvol = pl.deposit_invvol(geom, geom0, normalized_units)
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv            # velocity * c
    vy_c = p["uy"] * psi_inv
    vx = vx_c * cin                      # dimensionless
    vy = vy_c * cin
    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    q_m = charge / cfg.mass
    lnorm = pl.laser_norm(cfg, pc)
    if cfg.can_ionize:
        ion = p["ion_lev"].to(psi_inv.dtype)
        q_invvol = q_invvol * ion
        q_mu0_m = q_mu0_m * ion
        q_m = q_m * ion
        lnorm = lnorm * ion * ion
    if use_laser:
        with span("laser: |a|^2 gather"):
            a2 = gather_laser_aabs(p["x"], p["y"], fields["aabs"], geom,
                                   order)[0] * lnorm
        gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                           + vx * vx + vy * vy + 1.0)
    else:
        gamma_psi = 0.5 * (psi_inv * psi_inv + vx * vx + vy * vy + 1.0)
    wmask, bad = pl._qsa_mask(p, gamma_psi, psi_inv, cfg)
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
    # explicit Sx/Sy coefficient channels (ref ExplicitDeposition.cpp)
    # on a fine level the JAX package's explicit deposit weighs the masked
    # valid lanes without the QSA test (the level-0 deposit before it has
    # already invalidated the lanes that fail it there)
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
    # rho_<species> deposits the same charge density as rho
    vmain = [values["rho" if c.startswith("rho_") else c]
             for c in stack_comps] + chans
    rows = torch.stack(vmain + v2 + v3 if deriv_type == 2
                       else vmain + v3 + v2)
    ym, xm, _ = pl._deposit_positions(p, geom, extra_mask, geom0)
    return rows, ym, xm, p["w"] * wmask, p["valid"] & ~bad


def values_params(geom: Geometry, geom0: Geometry | None, cfg,
                  pc: PhysConst, normalized_units: bool) -> list:
    """The kernel's scalars (PARAMS), each the Python float that the plain
    version hands its op, so that the kernel's cast to the working type is
    the op's. The cell positions' division by dx and dy is PyTorch's on the
    card, a multiply by the working type's rounding of 1/dx and 1/dy taken
    in double: the kernel's cast of inv_dx and inv_dy."""
    charge = cfg.charge
    invvol = pl.deposit_invvol(geom, geom0, normalized_units)
    vals = {"q_invvol": charge * invvol,
            "q_mu0_m": charge * pc.mu0 / cfg.mass,
            "q_m": charge / cfg.mass, "lnorm": pl.laser_norm(cfg, pc),
            "cin": 1.0 / pc.c, "clight": pc.c,
            "cd_mu0": charge * invvol * pc.mu0,
            "max_qsa": cfg.max_qsa_weighting_factor,
            "inv_dx": 1.0 / geom.dx, "inv_dy": 1.0 / geom.dy,
            "x_off": geom.x_pos_offset, "y_off": geom.y_pos_offset,
            "guards": geom.nguards}
    return [float(vals[k]) for k in PARAMS]


def deposit_values_cuda(p: dict, stack_comps, fields: dict, geom: Geometry,
                        cfg, pc: PhysConst, order: int,
                        normalized_units: bool, deriv_type: int = 2,
                        use_laser: bool = False, extra_mask=None,
                        geom0: Geometry | None = None):
    """Launch the values kernel on CUDA tensors; returns what
    deposit_values_plain returns. An order or derivative type the kernel
    has no code for raises before the launch."""
    if not (0 <= order <= 3 and deriv_type in (0, 1, 2)):
        raise ValueError(f"unsupported order {order} / deriv_type "
                         f"{deriv_type}")
    x = p["x"]
    N = x.shape[0]
    dtype, device = x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x has dtype {dtype}, expected float32 or float64")
    for k in LANE_IN:
        cuda_lib.require(p[k], k, dtype=dtype, shape=(N,), device=device)
    cuda_lib.require(p["valid"], "valid", dtype=torch.bool, shape=(N,),
                     device=device)
    ion = p["ion_lev"] if cfg.can_ionize else None
    if ion is not None:
        cuda_lib.require(ion, "ion_lev", dtype=torch.int32, shape=(N,),
                         device=device)
    if extra_mask is not None:
        cuda_lib.require(extra_mask, "extra_mask", dtype=torch.bool,
                         shape=(N,), device=device)
    aabs = fields["aabs"] if use_laser else None
    NYa = NXa = 0
    if aabs is not None:
        if aabs.dim() != 2:
            raise ValueError(f"aabs must be (NY, NX), got "
                             f"{tuple(aabs.shape)}")
        NYa, NXa = aabs.shape
        cuda_lib.require(aabs, "aabs", dtype=dtype, device=device)
    codes = value_codes(stack_comps, deriv_type, use_laser)
    C = len(codes)
    NY, NX = geom.slice_shape
    rows = torch.empty((C, N), dtype=dtype, device=device)
    pos = torch.empty((2, N), dtype=dtype, device=device)
    w = torch.empty_like(p["w"])
    valid = torch.empty_like(p["valid"])
    if N:
        lanes = (ctypes.c_void_p * len(LANE_IN))(
            *[p[k].data_ptr() for k in LANE_IN])
        prm = (ctypes.c_double * len(PARAMS))(
            *values_params(geom, geom0, cfg, pc, normalized_units))
        code_arr = (ctypes.c_int * C)(*codes)
        fn = cuda_lib.library().fn("hipace_deposit_values", dtype)
        cuda_lib.launch(
            fn, x, rows.data_ptr(), pos.data_ptr(), w.data_ptr(),
            valid.data_ptr(), lanes, p["valid"].data_ptr(),
            None if ion is None else ion.data_ptr(),
            None if extra_mask is None else extra_mask.data_ptr(),
            None if aabs is None else aabs.data_ptr(), prm, code_arr, C, N,
            NY, NX, NYa, NXa, order, cuda_lib.stream_ptr(x),
            what="deposit_values")
        deposit_values.launches += 1
    return rows, pos[0], pos[1], w, valid


def deposit_values(p: dict, stack_comps, fields: dict, geom: Geometry, cfg,
                   pc: PhysConst, order: int, normalized_units: bool,
                   deriv_type: int = 2, use_laser: bool = False,
                   extra_mask=None, geom0: Geometry | None = None):
    """A species' values on a slice: CUDA tensors launch the kernel, CPU
    tensors take deposit_values_plain."""
    args = (p, stack_comps, fields, geom, cfg, pc, order, normalized_units,
            deriv_type, use_laser, extra_mask, geom0)
    if cuda_lib.use_kernel(p["x"]):
        return deposit_values_cuda(*args)
    return deposit_values_plain(*args)


deposit_values.launches = 0
