"""Simulation: configuration, the time step, the Evolve loop.

Port of the explicit-solver path of ``hipace_tpu/pipeline/simulation.py``
(ref Hipace.cpp:74-554). One time step re-initializes the plasma, deposits
the neutralizing background (K1), sweeps the slices head to tail through
``SliceStep`` and re-bins the pushed beam. Decks that select anything off
this path raise at construction (``unsupported.py``); there is no field or
particle output yet.
"""

from __future__ import annotations

import torch

from hipace_tpu.constants import make_constants
from hipace_tpu.geometry import Geometry
from hipace_tpu.parser import Inputs

from .. import device as dev_policy
from .. import unsupported
from ..particles import beam as bm
from ..particles import plasma as pl
from .step import (DIAG_COMPS, SimConfig, SliceStep, empty_slip,
                   init_field_state)


class Simulation:
    """End-to-end simulation (ref main.cpp:15-25: InitData + Evolve)."""

    def __init__(self, inputs: Inputs, device=None, dtype=None,
                 verbose: int | None = None):
        self.device, self.dtype = dev_policy.resolve(device, dtype)
        unsupported.check_deck(inputs)
        self.inputs = inputs
        self.normalized_units = inputs.query("hipace.normalized_units",
                                             False, bool)
        self.pc = make_constants(self.normalized_units)
        depos_order = inputs.query("hipace.depos_order_xy", 2, int)
        self.geom = Geometry.from_inputs(inputs, depos_order)
        self.max_step = inputs.query("max_step", 0, int)
        self.dt = inputs.query("hipace.dt", 0.0)
        self.time = 0.0
        self.verbose = (verbose if verbose is not None
                        else inputs.query("hipace.verbose", 1, int))

        particle_bc = inputs.query("boundary.particle", "Absorbing", str)
        plasma_names = inputs.query_list("plasmas.names", [], str)
        if plasma_names == ["no_plasma"]:
            plasma_names = []
        self.plasma_cfgs = tuple(
            pl.PlasmaConfig.from_inputs(inputs, n, self.pc, particle_bc)
            for n in plasma_names)
        beam_names = inputs.query_list("beams.names", [], str)
        if beam_names == ["no_beam"]:
            beam_names = []
        self.beam_cfgs = tuple(
            bm.BeamConfig.from_inputs(inputs, n, self.pc, self.geom,
                                      self.normalized_units)
            for n in beam_names)
        self.cfg = SimConfig(
            geom=self.geom, pc=self.pc,
            normalized_units=self.normalized_units,
            depos_order_xy=depos_order,
            do_beam_jx_jy_deposition=inputs.query(
                "hipace.do_beam_jx_jy_deposition", True, bool),
            MG_tolerance_rel=inputs.query("hipace.MG_tolerance_rel", 1e-4),
            MG_tolerance_abs=inputs.query("hipace.MG_tolerance_abs", 0.0),
            poisson_solver=inputs.query("fields.poisson_solver",
                                        "FFTDirichletFast", str),
            plasmas=self.plasma_cfgs, beams=self.beam_cfgs)

        # ---- beam init (flat) + capacity planning + binning
        seed = inputs.query("hipace.random_seed", 0, int)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.beam_cfgs:
            flat = bm.init_beam(self.beam_cfgs[0], self.geom, self.generator,
                                self.device, self.dtype, self.pc)
            self.beam_cap = bm.plan_capacity(flat, self.geom)
        else:
            flat = {k: torch.zeros(1, dtype=v.dtype, device=self.device)
                    for k, v in empty_slip(self.device, self.dtype).items()}
            self.beam_cap = 1
        self.binned = bm.bin_beam(flat, self.geom, self.beam_cap)
        self.slice_step = SliceStep(self.cfg, self.device, self.dtype)

    # ------------------------------------------------------------------
    def _time_step(self, binned: dict, time: float, dt: float) -> dict:
        """One full time step: plasma re-init, neutralizing background, the
        slice sweep from the head (last slice) to the tail, re-binning."""
        cfg, g = self.cfg, self.geom
        fields = init_field_state(cfg, self.device, self.dtype)
        # fresh plasma for this step (ref Hipace.cpp:450)
        plasmas = [pl.init_plasma(pcfg, g, self.device, self.dtype,
                                  self.pc.c * time, self.normalized_units)
                   for pcfg in self.plasma_cfgs]
        # neutralizing background (ref Hipace.cpp:455-472)
        rhomjz_ion = fields["RhomJzIons"]["rhomjz"]
        for p, pcfg in zip(plasmas, self.plasma_cfgs):
            if pcfg.neutralize_background:
                tmp, _ = pl.deposit_plasma(
                    p, ["rhomjz"], {"rhomjz": rhomjz_ion}, g, pcfg, self.pc,
                    cfg.depos_order_xy, cfg.normalized_units,
                    flip_charge=True)
                rhomjz_ion = tmp["rhomjz"]
        fields["RhomJzIons"] = {"rhomjz": rhomjz_ion}

        carry = {"fields": fields, "plasma": plasmas,
                 "slip": empty_slip(self.device, self.dtype), "dt": dt}
        nz = g.nz
        beam = {k: binned[k] for k in bm.ALL_ATTRS}
        empty_next = {k: torch.zeros_like(v[0]) for k, v in beam.items()}
        emitted = [None] * nz
        diag = torch.empty((nz, len(DIAG_COMPS), g.ny, g.nx),
                           dtype=self.dtype, device=self.device)
        cycles = []
        for islice in range(nz - 1, -1, -1):
            this = {k: v[islice] for k, v in beam.items()}
            nxt = ({k: v[islice - 1] for k, v in beam.items()} if islice
                   else empty_next)
            carry, out = self.slice_step(carry, islice, this, nxt)
            emitted[islice] = out["beam_out"]
            diag[islice] = out["diag"]
            cycles.append(out["mg_cycles"])
        # merge emitted beam + final slip, re-bin by new z
        flat = {k: torch.cat([e[k] for e in emitted] + [carry["slip"][k]])
                for k in bm.ALL_ATTRS}
        return {"binned": bm.bin_beam(flat, g, self.beam_cap), "diag": diag,
                "mg_cycles": cycles}

    def run_step(self, step: int) -> dict:
        return self._time_step(self.binned, self.time, self.dt)

    def evolve(self):
        """Time loop (ref Hipace.cpp:393-507), without output."""
        for step in range(self.max_step + 1):
            if self.verbose >= 1:
                print(f"Rank 0 started step {step} at time {self.time}"
                      f" with dt {self.dt}")
            res = self.run_step(step)
            self.binned = res["binned"]
            self.time += self.dt
        return self
