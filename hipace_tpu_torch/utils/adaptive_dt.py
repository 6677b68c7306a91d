"""Adaptive time step (ref AdaptiveTimeStep.{H,cpp}).

The port's own copy of ``hipace_tpu/utils/adaptive_dt.py``: dt = 2 pi /
(omega_beta * nt_per_betatron), omega_beta = sqrt(n_q / (2 |min_uz m/q|
ep0)), from the beam's weighted uz moments that the slice sweep accumulates
on the device (read back once per step), with the prediction over the next
steps through the plasma density and the phase-advance control. All of it
is host arithmetic on Python floats and numpy; the deck's density
expressions are evaluated on float64 CPU tensors.

As in the JAX package, the mass and charge of the FIRST beam set the
betatron frequency whatever beam the moments come from (ROADMAP R4).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import PhysConst
from ..parser import Inputs


@dataclasses.dataclass(frozen=True)
class AdaptiveTimeStepConfig:
    enabled: bool = False
    nt_per_betatron: float = 20.0
    dt_max: float = float("inf")
    threshold_uz: float = 2.0
    predict_step: bool = True
    control_phase_advance: bool = True
    phase_tolerance: float = 4e-4
    phase_substeps: int = 2000
    # plasmas.adaptive_density: a density floor in the max over species
    # (ref MultiPlasma.cpp:21,66), so a beam in vacuum can run adaptive dt
    adaptive_density: float = 0.0

    @classmethod
    def from_inputs(cls, inputs: Inputs) -> "AdaptiveTimeStepConfig":
        pp = inputs.prefix("hipace")
        return cls(
            enabled=inputs.raw("hipace.dt", "") == "adaptive",
            adaptive_density=inputs.query("plasmas.adaptive_density", 0.0),
            nt_per_betatron=pp.query("nt_per_betatron", 20.0),
            dt_max=pp.query("dt_max", float("inf")),
            threshold_uz=pp.query("adaptive_threshold_uz", 2.0),
            predict_step=pp.query("adaptive_predict_step", True, bool),
            control_phase_advance=pp.query(
                "adaptive_control_phase_advance", True, bool),
            phase_tolerance=pp.query("adaptive_phase_tolerance", 4e-4),
            phase_substeps=pp.query("adaptive_phase_substeps", 2000, int),
        )


def initial_moments(beam_cfg) -> dict:
    """The estimate before any particle exists (ref
    AdaptiveTimeStep.cpp:99-109)."""
    uz = beam_cfg.u_mean[2]
    std = beam_cfg.u_std[2]
    return {"sum_w": 1.0, "sum_w_uz": uz, "sum_w_uz2": uz * uz + std * std,
            "min_uz": uz - 4.0 * std, "min_acc": 0.0}


def _density_on_axis(pcfg, zs: np.ndarray) -> np.ndarray:
    """A species' density at x = y = 0 and z = zs (float64, host)."""
    z = torch.as_tensor(np.asarray(zs, np.float64))
    zero = torch.zeros_like(z)
    return pcfg.density_fn()(zero, zero, z).numpy()


def max_charge_density(plasma_cfgs, pc: PhysConst, c_t: float,
                       adaptive_density: float = 0.0) -> float:
    """ref MultiPlasma.cpp:64-73."""
    md = abs(adaptive_density * pc.q_e)
    for pcfg in plasma_cfgs:
        md = max(md, abs(pcfg.charge
                         * float(_density_on_axis(pcfg, [c_t])[0])))
    return md


def calculate_from_min_uz(cfg: AdaptiveTimeStepConfig, moments: dict,
                          beam_cfg, plasma_cfgs, pc: PhysConst,
                          t: float, dt: float, numprocs: int = 1):
    """New dt from the beam's min uz (ref AdaptiveTimeStep.cpp:162-259).

    Returns (new_dt, min_uz_mq) with min_uz_mq = |chosen min uz * m/q|, which
    the phase-advance control reads."""
    if not cfg.enabled or beam_cfg.charge == 0.0:
        return dt, float("inf")
    mass_charge_ratio = beam_cfg.mass / beam_cfg.charge
    sw = moments["sum_w"]
    if sw == 0.0:
        return dt, float("inf")
    mean_uz = moments["sum_w_uz"] / sw
    sigma_uz = math.sqrt(abs(moments["sum_w_uz2"] / sw - mean_uz * mean_uz))
    chosen = min(max(mean_uz - 4.0 * sigma_uz, moments["min_uz"]), 1e30)
    chosen = max(chosen, cfg.threshold_uz)
    min_uz_mq = abs(chosen * mass_charge_ratio)

    new_time = t
    min_uz = chosen
    out_dt = dt
    for _ in range(numprocs if cfg.predict_step else 1):
        n_q = max_charge_density(plasma_cfgs, pc, pc.c * new_time,
                                 cfg.adaptive_density)
        if n_q <= 0.0:
            raise ValueError("adaptive dt needs a >0 plasma density")
        min_uz = max(min_uz, 0.001 * cfg.threshold_uz)
        omega_b = math.sqrt(n_q / (2.0 * abs(min_uz * mass_charge_ratio)
                                   * pc.ep0))
        new_dt = 2.0 * math.pi / omega_b / cfg.nt_per_betatron
        new_time += new_dt
        if min_uz > cfg.threshold_uz:
            out_dt = new_dt
    return min(out_dt, cfg.dt_max), min_uz_mq


def calculate_from_density(cfg: AdaptiveTimeStepConfig, plasma_cfgs,
                           pc: PhysConst, t: float, dt: float,
                           min_uz_mq: float) -> float:
    """Phase-advance control through density gradients (ref
    AdaptiveTimeStep.cpp:320-370)."""
    if not cfg.enabled or not cfg.control_phase_advance \
            or not math.isfinite(min_uz_mq):
        return dt
    dt_sub = dt / cfg.phase_substeps
    n0 = max_charge_density(plasma_cfgs, pc, pc.c * t, cfg.adaptive_density)
    omgb0 = math.sqrt(n0 / (2.0 * min_uz_mq * pc.ep0))
    zs = pc.c * (t + np.arange(cfg.phase_substeps) * dt_sub)
    n_of_z = np.zeros_like(zs)
    for pcfg in plasma_cfgs:
        n_of_z = np.maximum(n_of_z, np.abs(pcfg.charge
                                           * _density_on_axis(pcfg, zs)))
    omgb = np.sqrt(n_of_z / (2.0 * min_uz_mq * pc.ep0))
    dphase = np.cumsum((omgb - omgb0) * dt_sub)
    bad = np.abs(dphase) > (2.0 * math.pi * cfg.phase_tolerance
                            / cfg.nt_per_betatron)
    if bad.any():
        return int(np.argmax(bad)) * dt_sub
    return dt
