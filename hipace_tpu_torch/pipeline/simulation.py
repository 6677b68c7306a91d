"""Simulation: configuration, the time step, the Evolve loop and its output.

Port of ``hipace_tpu/pipeline/simulation.py`` for the explicit and
predictor-corrector Bx/By solvers (ref Hipace.cpp:74-554). One time step
re-initializes every plasma species (its temperature's draws from the
simulation's generator; the density table's expression for c*t, chosen by
``advance``), deposits the neutralizing background (K1), sweeps the slices
head to tail through ``SliceStep`` and re-bins the pushed beams. Every beam
of the deck is drawn in deck order from the simulation's generator, merged
(a ``beam_id`` per lane) and binned with one capacity planned on the merged
lanes.

A laser (``lasers.names``) streams its envelope between steps: (n00, nm1),
complex (nz, NY, NX) tensors on the device, each step's advanced and current
envelopes becoming the next step's. Under ``hipace.dt = adaptive`` the time
loop sets dt from the beam's uz moments, which the sweep accumulates on the
device and which are read back once per step (the initial dt from the first
beam's initial moments); ``hipace.max_time`` makes the step that reaches it
land on it exactly and runs one more step with dt = 0 (ref
Hipace.cpp:424-435).

Field ionization (``<species>.ionization_product``) gives the ion species
its ADK constants and its product species one spawn slot per ion lane and
level, padded onto the product's own lanes; Coulomb collisions
(``hipace.collisions``) are configured per ``<name>.species`` pair. Both
draw their uniforms on every slice from the simulation's generator
(``step.UniformDraws``); in normalized units both need
``hipace.background_density_SI``.

SALAME (``<beam>.do_salame``, explicit solver only) runs at step 0 on the
slices that hold a SALAME lane, found from the binned beam with one read of
the device. Mesh refinement (``amr.max_level``) builds each level's coupler,
Poisson solver and multigrid once; each step deposits the levels'
neutralizing background (or interpolates it from the parent level), and the
levels' diagnostics are written on their own grids.

Output follows the JAX package: the named field diagnostics and each beam
(from the binned beams before the step's push) go to openPMD files, the
in-situ moments to reduced-diagnostics files, one per beam. The slice step
leaves every diagnostic on the device; a written step reads each of its
buffers back once, after the sweep.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from .. import device as dev_policy
from ..constants import make_constants
from ..diagnostics import insitu as ins
from ..diagnostics.openpmd import BEAM_RECORDS, OpenPMDWriter
from ..fields import laser as lz
from ..fields.mr import in_level_bounds, parse_mr_levels
from ..geometry import Geometry
from ..parser import Inputs, deck_function
from ..particles import beam as bm
from ..particles import plasma as pl
from ..tracing import span, traced
from ..utils import adaptive_dt as adt
from .salame import empty_salame_state
from .step import (DIAG_COMPS, THIS_COMPS_PC, DiagConfig, SimConfig,
                   SliceStep, UniformDraws, diag_slice_shape, empty_slip,
                   init_field_state, is_full_interior, zero_moments)


def _read_counts(*groups) -> None:
    """Replace the counts in each group (a list, or a dict of counts or of
    lists of counts) by ints: on the card they are 0-d device tensors, all
    read in one copy."""
    slots = []
    for grp in groups:
        for k in (range(len(grp)) if isinstance(grp, list) else list(grp)):
            if isinstance(grp[k], list):
                slots += [(grp[k], j) for j in range(len(grp[k]))]
            else:
                slots.append((grp, k))
    vals = [c[k] for c, k in slots]
    # the site's span also where the counts are ints already (the CPU)
    with span("read: step counts"):
        dev = next((v.device for v in vals if torch.is_tensor(v)), None)
        if dev is None:
            return
        read = torch.stack([torch.as_tensor(v, device=dev).reshape(())
                            .to(torch.int64) for v in vals]).tolist()
    for (c, k), v in zip(slots, read):
        c[k] = v


class Simulation:
    """End-to-end simulation (ref main.cpp:15-25: InitData + Evolve)."""

    def __init__(self, inputs: Inputs, device=None, dtype=None,
                 verbose: int | None = None):
        self.device, self.dtype = dev_policy.resolve(device, dtype)
        self.inputs = inputs
        self.normalized_units = inputs.query("hipace.normalized_units",
                                             False, bool)
        self.pc = make_constants(self.normalized_units)
        depos_order = inputs.query("hipace.depos_order_xy", 2, int)
        self.geom = Geometry.from_inputs(inputs, depos_order)
        self.mr_levels = parse_mr_levels(inputs, self.geom)
        # ref parameters.rst:159-161: print all input parameters
        if inputs.query("hipace.output_input", False, bool):
            for k in sorted(inputs._raw):
                print(f"{k} = {inputs._raw[k]}")
        self.max_step = inputs.query("max_step", 0, int)
        self.max_time = inputs.query("hipace.max_time", float("inf"))
        self._has_last_step = False
        self.adt_cfg = adt.AdaptiveTimeStepConfig.from_inputs(inputs)
        # adaptive: set from the initial beam moments below
        self.dt = 0.0 if self.adt_cfg.enabled else inputs.query("hipace.dt",
                                                                0.0)
        self.time = 0.0
        self.verbose = (verbose if verbose is not None
                        else inputs.query("hipace.verbose", 1, int))

        solver = inputs.query("hipace.bxby_solver", "explicit", str)
        pusher = inputs.query("hipace.plasma_pusher", "leapfrog", str)
        if pusher not in ("leapfrog", "ab5"):
            raise ValueError(f"hipace.plasma_pusher = {pusher}: leapfrog or "
                             "ab5")
        deriv_type = inputs.query("hipace.depos_derivative_type", 2, int)
        if deriv_type not in (0, 1, 2):
            raise ValueError(f"hipace.depos_derivative_type = {deriv_type}: "
                             "0, 1 or 2")
        particle_bc = inputs.query("boundary.particle", "Absorbing", str)
        plasma_names = inputs.query_list("plasmas.names", [], str)
        if plasma_names == ["no_plasma"]:
            plasma_names = []
        plasma_cfgs = [
            pl.PlasmaConfig.from_inputs(inputs, n, self.pc, particle_bc)
            for n in plasma_names]
        bg_si = inputs.query("hipace.background_density_SI", 0.0)
        self.ionization_pairs, self.spawn_extra = self._ionization_cfg(
            plasma_cfgs, plasma_names, bg_si)
        self.plasma_cfgs = tuple(plasma_cfgs)
        if self.mr_levels and self.plasma_cfgs and not any(
                p.fine_patch_expr for p in self.plasma_cfgs):
            # as the JAX package warns: one coarse ppc over ratio^2 fine
            # cells aliases the fine level's charge
            ratio = self.geom.dx / min(lv.geom.dx for lv in self.mr_levels)
            if ratio >= 2.0:
                print("WARNING: mesh refinement at >=2x without any "
                      "plasma.fine_patch/fine_ppc: the fine-level plasma "
                      "charge will be aliased (1 coarse ppc per "
                      f"~{ratio * ratio:.0f} fine cells) and in-patch "
                      "fields unreliable. Define <plasma>.fine_patch(x,y) "
                      "and <plasma>.fine_ppc covering the patch.",
                      file=sys.stderr)
        beam_names = inputs.query_list("beams.names", [], str)
        if beam_names == ["no_beam"]:
            beam_names = []
        self.beam_cfgs = tuple(
            bm.BeamConfig.from_inputs(inputs, n, self.pc, self.geom,
                                      self.normalized_units)
            for n in beam_names)

        laser_cfg = lz.LaserConfig.from_inputs(inputs, self.pc)
        self.laser_cfg = laser_cfg if laser_cfg.use_laser else None
        self.laser_geom, self.laser_zeta = None, None
        if self.laser_cfg is not None:
            self.laser_geom, lz_lo, lz_hi = lz.make_laser_geometry(
                inputs, self.geom)
            self.laser_zeta = (lz_lo, lz_hi)
        # the laser stream (n00, nm1), complex (nz, NY, NX) on the device;
        # None: zeros, as before the first step
        self.laser_stream = None
        if laser_cfg.from_file:
            env = lz.load_laser_from_file(
                laser_cfg, self.laser_geom, self.dtype,
                zeta_lo=self.laser_zeta[0], nz_global=self.geom.nz,
                clight=self.pc.c, device=self.device)
            # nm1 is not read at step 0 (two-level scheme): seed it with n00
            self.laser_stream = (env, env)

        self.output_period = inputs.query("diagnostic.output_period", -1, int)
        self.beam_output_period = inputs.query(
            "diagnostic.beam_output_period", self.output_period, int)
        beam_data = inputs.query_list("diagnostic.beam_data", ["all"], str)
        if beam_data == ["all"]:
            self.beam_data = tuple(beam_names)
        elif beam_data == ["none"]:
            self.beam_data = ()
        else:
            self.beam_data = tuple(beam_data)
        self.diags, field_data, dep_rho, dep_rho_ind = self._parse_diags(
            inputs, solver == "explicit", plasma_names)
        self._insitu_laser = inputs.query("lasers.insitu_period", 0, int)

        def period(key, names):
            return max([inputs.query(f"{n}.insitu_period",
                                     inputs.query(key, 0, int), int)
                        for n in names] or [0])

        self.cfg = SimConfig(
            geom=self.geom, pc=self.pc,
            normalized_units=self.normalized_units,
            explicit=(solver == "explicit"),
            depos_order_xy=depos_order,
            depos_derivative_type=deriv_type,
            plasma_pusher=pusher,
            do_beam_jx_jy_deposition=inputs.query(
                "hipace.do_beam_jx_jy_deposition", True, bool),
            do_beam_jz_minus_rho=inputs.query(
                "hipace.do_beam_jz_minus_rho", False, bool),
            do_symmetrize=inputs.query("fields.do_symmetrize", False, bool),
            open_boundary=(inputs.query("boundary.field", "Dirichlet",
                                        str).lower() == "open"),
            predcorr_B_error_tolerance=inputs.query(
                "hipace.predcorr_B_error_tolerance", 4e-2),
            predcorr_max_iterations=inputs.query(
                "hipace.predcorr_max_iterations", 30, int),
            predcorr_B_mixing_factor=inputs.query(
                "hipace.predcorr_B_mixing_factor", 0.05),
            MG_tolerance_rel=inputs.query("hipace.MG_tolerance_rel", 1e-4),
            MG_tolerance_abs=inputs.query("hipace.MG_tolerance_abs", 0.0),
            poisson_solver=inputs.query("fields.poisson_solver",
                                        "FFTDirichletFast", str),
            plasmas=self.plasma_cfgs, beams=self.beam_cfgs,
            diag_comps=tuple(field_data), diags=self.diags,
            deposit_rho=dep_rho, deposit_rho_individual=dep_rho_ind,
            insitu_beam_period=period("beams.insitu_period", beam_names),
            insitu_field_period=inputs.query("fields.insitu_period", 0, int),
            insitu_plasma_period=period("plasmas.insitu_period",
                                        plasma_names),
            insitu_radius=inputs.query("beams.insitu_radius", float("inf")),
            background_density_SI=inputs.query(
                "hipace.background_density_SI", 0.0),
            grid_current=self._grid_current_cfg(inputs),
            laser=self.laser_cfg, laser_geom=self.laser_geom,
            laser_zeta=self.laser_zeta,
            insitu_laser_period=self._insitu_laser,
            adaptive_dt=self.adt_cfg.enabled,
            ionization_pairs=self.ionization_pairs,
            collisions=self._collision_cfg(inputs, plasma_names,
                                           beam_names),
            mr_levels=self.mr_levels,
            salame_n_iter=inputs.query("hipace.salame_n_iter", 3, int),
            salame_do_advance=inputs.query("hipace.salame_do_advance", True,
                                           bool),
            salame_tolerance=inputs.query("hipace.salame_relative_tolerance",
                                          1e-4),
            salame_target_expr=deck_function(
                inputs, ("hipace.salame_Ez_target",),
                ("zeta", "zeta_initial", "Ez_initial"),
                default="Ez_initial").expr,
            salame_consts=tuple(sorted(
                (k, float(v)) for k, v in inputs.my_constants.items()
                if isinstance(v, (int, float)))))
        for what, used in (
                ("radiation reaction", any(b.do_radiation_reaction
                                           for b in self.beam_cfgs)),
                ("collisions", bool(self.cfg.collisions))):
            if used and self.normalized_units and bg_si <= 0.0:
                raise ValueError(f"{what} in normalized units needs "
                                 "hipace.background_density_SI for the "
                                 "plasma frequency")

        # ---- beam init (flat) + capacity planning + binning
        seed = inputs.query("hipace.random_seed", 0, int)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.beam_cfgs:
            beams = [bm.init_beam(b, self.geom, self.generator, self.device,
                                  self.dtype, self.pc, self.normalized_units)
                     for b in self.beam_cfgs]
            flat = bm.merge_beams(beams)
            self.beam_cap = bm.plan_capacity(flat, self.geom)
        else:
            flat = {k: torch.zeros(1, dtype=v.dtype, device=self.device)
                    for k, v in empty_slip(self.device, self.dtype).items()}
            self.beam_cap = 1
        self.binned = bm.bin_beam(flat, self.geom, self.beam_cap)
        self.slice_step = SliceStep(
            self.cfg, self.device, self.dtype,
            UniformDraws(self.generator, self.device, self.dtype))

        # the initial adaptive dt from the first beam's initial moments (ref
        # AdaptiveTimeStep.cpp GatherMinUzSlice(initial=true),
        # Hipace.cpp:275-281)
        self.min_uz_mq = float("inf")
        if self.adt_cfg.enabled and self.beam_cfgs:
            self.dt, self.min_uz_mq = adt.calculate_from_min_uz(
                self.adt_cfg, self._initial_beam_moments(beams[0]),
                self.beam_cfgs[0], self.plasma_cfgs, self.pc, 0.0, 1e30)

        # the openPMD writer, where any step can write (a writer asked for
        # h5 raises here if h5py does not import)
        writes = (any(dg.period != 0 for dg in self.diags)
                  or (self.beam_data and self.beam_output_period != 0))
        self.writer = OpenPMDWriter(
            inputs.query("hipace.file_prefix", "diags/hdf5", str),
            self.normalized_units,
            backend=inputs.query("hipace.openpmd_backend", "h5",
                                 str)) if writes else None
        self._insitu_writers = {}

    def _ionization_cfg(self, plasma_cfgs: list, plasma_names, bg_si):
        """Attach the ADK constants to each ionizing species of plasma_cfgs
        (a species that can ionize and names its product) and plan its
        product's spawn slots: the product's own lanes, then one block of
        (ion lanes x levels) per ionizing parent. Returns (the pairs
        (ion, product, first spawn slot, the product's initial_ion_level),
        the extra lanes of each species)."""
        pairs, extra = [], [0] * len(plasma_cfgs)
        for i, pcfg in enumerate(plasma_cfgs):
            if not (pcfg.can_ionize and pcfg.ionization_product):
                continue
            if self.normalized_units and bg_si <= 0.0:
                raise ValueError(f"{pcfg.name}: ionization in normalized "
                                 "units needs hipace.background_density_SI "
                                 "for the plasma frequency")
            adk = pl.adk_constants(pcfg, self.geom.dz, self.normalized_units,
                                   bg_si)
            plasma_cfgs[i] = dataclasses.replace(pcfg, adk=adk)
            j = plasma_names.index(pcfg.ionization_product)
            spawn_base = pl.plasma_count(plasma_cfgs[j], self.geom) + extra[j]
            extra[j] += pl.plasma_count(pcfg, self.geom) * len(adk)
            pairs.append((i, j, spawn_base, plasma_cfgs[j].init_ion_lev))
        return tuple(pairs), tuple(extra)

    @staticmethod
    def _collision_cfg(inputs, plasma_names, beam_names) -> tuple:
        """hipace.collisions and each one's <name>.species (ref
        CoulombCollision.cpp:8-60): ("bp", beam, plasma, False, Coulomb
        log) where one species is a beam, else ("pp", plasma, plasma, same
        species, Coulomb log)."""
        out = []
        for cname in inputs.query_list("hipace.collisions", [], str):
            sp = inputs.get_list(f"{cname}.species", str)
            clog = inputs.query(f"{cname}.CoulombLog", -1.0)
            if sp[0] in beam_names:
                out.append(("bp", beam_names.index(sp[0]),
                            plasma_names.index(sp[1]), False, clog))
            elif sp[1] in beam_names:
                out.append(("bp", beam_names.index(sp[1]),
                            plasma_names.index(sp[0]), False, clog))
            else:
                out.append(("pp", plasma_names.index(sp[0]),
                            plasma_names.index(sp[1]), sp[0] == sp[1], clog))
        return tuple(out)

    def _initial_beam_moments(self, beam: dict) -> dict:
        """The first beam's weighted uz moments (in units of c) and its
        least uz, as floats (read once, at construction)."""
        v = beam["valid"]
        w = beam["w"][v].double()
        uz = beam["uz"][v].double() / self.pc.c
        if float(w.sum()) == 0.0:
            return adt.initial_moments(self.beam_cfgs[0])
        return {"sum_w": float(w.sum()), "sum_w_uz": float((w * uz).sum()),
                "sum_w_uz2": float((w * uz * uz).sum()),
                "min_uz": float(uz.min()), "min_acc": 0.0}

    def _parse_diags(self, inputs, explicit, plasma_names):
        """The named field diagnostics (ref Diagnostic.cpp; parameter docs
        parameters.rst:932-1110) on level 0 and, with a laser, on the laser
        grid (base_geometry = laser, the default of laser_diag). Returns
        (diags, the identity diagnostics' union of comps, deposit_rho,
        deposit_rho_individual)."""
        g = self.geom
        inf = float("inf")
        use_laser = self.laser_cfg is not None
        names = inputs.query_list("diagnostic.names", ["lev0"] + (
            ["laser_diag"] if use_laser else []), str)
        if names == ["no_field_diag"]:
            names = []
        # field_data=all writes every allocated comp of the solver: chi,
        # Sx and Sy included for the explicit one (matches the reference's
        # checksum benchmarks), aabs with a laser (ref Fields.cpp:89,137)
        all_comps = list(DIAG_COMPS if explicit else THIS_COMPS_PC)
        avail = set(all_comps) | {"rho"} | {f"rho_{p}" for p in plasma_names}
        if use_laser:
            all_comps.append("aabs")
            avail |= {"aabs"} | (set() if explicit else {"chi"})
        dd = inputs.prefix("diagnostic")
        dep_rho = inputs.query("hipace.deposit_rho", False, bool)
        dep_rho_ind = inputs.query("hipace.deposit_rho_individual", False,
                                   bool)

        def patch_range(lo, hi, plo, d, n):
            i0 = 0 if lo == -inf else max(0, int(math.ceil(
                (lo - plo) / d - 0.5)))
            i1 = n - 1 if hi == inf else min(n - 1, int(math.floor(
                (hi - plo) / d - 0.5)))
            return (i0, max(i0, i1))

        diags = []
        for name in names:
            pp = inputs.prefix(name)

            def q(k, dflt, ty=None):
                return pp.query(k, dd.query(k, dflt, ty), ty)

            base = q("base_geometry", {"laser_diag": "laser"}.get(
                name, "level_0"), str)
            # a fine level that the deck does not have, or the laser grid
            # without a laser: their diagnostics are skipped, as the JAX
            # package skips them
            lev = int(base[-1]) if base in ("level_1", "level_2") else 0
            if lev > len(self.mr_levels) or (base == "laser"
                                             and not use_laser):
                continue
            laser_base = base == "laser"
            dgeom = (self.laser_geom if laser_base
                     else self.mr_levels[lev - 1].geom if lev else g)
            period = pp.query("output_period",
                              dd.query("output_period", self.output_period,
                                       int), int)
            comps: list = []
            for tok in pp.query_list("field_data", dd.query_list(
                    "field_data", ["laserEnvelope"] if laser_base
                    else ["all"], str), str):
                if tok == "all":
                    comps = (["laserEnvelope"] if laser_base
                             else list(all_comps))
                elif tok == "none":
                    comps = []
                elif tok.startswith("remove_"):
                    comps = [c for c in comps if c != tok[len("remove_"):]]
                elif tok == "laserEnvelope":
                    if laser_base:
                        comps.append(tok)
                else:
                    if tok == "rho":
                        dep_rho = True
                    if tok.startswith("rho_") and tok[4:] in plasma_names:
                        dep_rho_ind = True
                    if tok in avail:
                        comps.append(tok)
            seen = set()
            comps = [c for c in comps if not (c in seen or seen.add(c))]
            if not comps:
                continue
            plo = pp.query_list("patch_lo",
                                dd.query_list("patch_lo", [-inf] * 3), float)
            phi = pp.query_list("patch_hi",
                                dd.query_list("patch_hi", [inf] * 3), float)
            patch_z = patch_range(plo[2], phi[2], g.prob_lo[2], g.dz, g.nz)
            if laser_base and dgeom is not g:
                if any(c != "laserEnvelope" for c in comps):
                    raise ValueError(f"{name}: a diagnostic on a separate "
                                     "laser grid writes laserEnvelope only")
                # the transverse patch in the laser grid; the z range in
                # field slices, clipped to the laser's zeta span
                patch_z = (max(patch_z[0], self.laser_zeta[0]),
                           min(patch_z[1], self.laser_zeta[1]))
            if lev:
                # the z range clipped to the level's slices
                lv = self.mr_levels[lev - 1]
                patch_z = (max(patch_z[0], lv.zeta_lo),
                           min(patch_z[1], lv.zeta_hi))
            diags.append(DiagConfig(
                name=name, base=base, diag_type=q("diag_type", "xyz", str),
                comps=tuple(comps),
                coarsening=tuple(pp.query_list(
                    "coarsening", dd.query_list("coarsening", [1, 1, 1],
                                                int), int)),
                include_ghosts=bool(q("include_ghost_cells", False, bool)),
                patch_x=patch_range(plo[0], phi[0], dgeom.prob_lo[0],
                                    dgeom.dx, dgeom.nx),
                patch_y=patch_range(plo[1], phi[1], dgeom.prob_lo[1],
                                    dgeom.dy, dgeom.ny),
                patch_z=patch_z, period=period))

        # the union served by the full-interior stack (kept for period-0
        # diagnostics too, so the step's "diag" stays available to callers)
        union: list = []
        for dg in diags:
            if is_full_interior(dg, g):
                union.extend(c for c in dg.comps if c not in union)
        # period-0 diagnostics never write: the others are not processed
        kept = tuple(dg for dg in diags
                     if dg.period != 0 or is_full_interior(dg, g))
        return kept, union, dep_rho, dep_rho_ind

    @staticmethod
    def _grid_current_cfg(inputs):
        """grid_current.* (ref utils/GridCurrent.cpp): (peak current
        density, mean, std) or None."""
        pp = inputs.prefix("grid_current")
        if not pp.query("use_grid_current", False, bool):
            return None
        return (pp.get("peak_current_density"),
                tuple(pp.get_list("position_mean")),
                tuple(pp.get_list("position_std")))

    # ------------------------------------------------------------------
    def _fine_background(self, fields: dict, plasmas: list,
                         slice_step) -> None:
        """The fine levels' neutralizing background (ref
        Hipace.cpp:455-471), into fields' mr<level> sets: each level's own
        K1 deposit of the lanes inside it at the level-0 density or, with
        hipace.interpolate_neutralizing_background, its parent's
        interpolated through slice_step's couplers."""
        cfg = self.cfg
        interp = self.inputs.query(
            "hipace.interpolate_neutralizing_background", False, bool)
        parent_rhom = fields["RhomJzIons"]["rhomjz"]
        for i, lv in enumerate(cfg.mr_levels):
            fion = fields[f"mr{i + 1}"]["RhomJzIons"]["rhomjz"]
            if interp:
                fion = slice_step.couplers[i].up_full(parent_rhom)
            else:
                for p, pcfg in zip(plasmas, self.plasma_cfgs):
                    if pcfg.neutralize_background:
                        fion = pl.deposit_plasma(
                            p, ["rhomjz"], {"rhomjz": fion}, lv.geom, pcfg,
                            self.pc, cfg.depos_order_xy,
                            cfg.normalized_units, flip_charge=True,
                            extra_mask=in_level_bounds(p["x"], p["y"],
                                                       lv.geom),
                            geom0=self.geom)[0]["rhomjz"]
            fields[f"mr{i + 1}"]["RhomJzIons"] = {"rhomjz": fion}
            parent_rhom = fion

    def _diag_base_geom(self, dg) -> Geometry:
        """The grid of a diagnostic's base geometry."""
        if dg.base == "laser":
            return self.laser_geom
        if dg.base != "level_0":
            return self.mr_levels[int(dg.base[-1]) - 1].geom
        return self.geom

    def plasma_draws(self) -> list:
        """Each species' temperature draws for one time step, from the
        simulation's generator (None for a cold species)."""
        return [pl.plasma_draws(pcfg, self.geom, self.generator, self.device,
                                self.dtype) for pcfg in self.plasma_cfgs]

    @traced("plasma init")
    def step_state(self, time: float, dt: float, step: int, slice_step,
                   device, binned: dict | None = None, draws=None) -> dict:
        """A time step's state before its sweep, on `device` through
        `slice_step`: the carry (fresh plasma of every species from `draws`,
        plasma_draws' list, drawn here when None; the neutralizing
        background of every level; with a laser, its empty state and chi
        from the density profile), the sweep's output buffers and its count
        lists. binned, the step's input beam, is read only at step 0 with
        SALAME, for the slices SALAME runs on."""
        cfg, g = self.cfg, self.geom
        dev = dict(dtype=self.dtype, device=device)
        if draws is None:
            draws = self.plasma_draws()
        fields = init_field_state(cfg, device, self.dtype)
        # fresh plasma for this step (ref Hipace.cpp:450)
        plasmas = [pl.pad_plasma(pl.init_plasma(
            pcfg, g, device, self.dtype, self.pc.c * time,
            self.normalized_units, draws=dr,
            ab5=cfg.plasma_pusher == "ab5"), extra)
            for pcfg, extra, dr in zip(self.plasma_cfgs, self.spawn_extra,
                                       draws)]
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
        self._fine_background(fields, plasmas, slice_step)

        carry = {"fields": fields, "plasma": plasmas,
                 "slip": empty_slip(device, self.dtype), "dt": dt,
                 "time": torch.tensor(time, **dev), "step": step}
        if cfg.adaptive_dt:
            carry["beam_moments"] = zero_moments(device, self.dtype)
            carry["min_uz"] = torch.full((), math.inf, **dev)
        nz = g.nz
        lg = self.laser_geom
        st = {"slice_step": slice_step, "cycles": [], "pc_iters": [],
              "pc_err": [], "laser_cycles": [],
              # V-cycles of the other K3 solves: SALAME's per SALAME slice,
              # each fine level's per slice it runs, keyed by slice
              "extra_cycles": {}}
        if cfg.use_laser:
            carry["laser"] = lz.laser_empty_state(lg, self.dtype, device)
            carry["chi_initial"] = lz.initial_chi(
                self.plasma_cfgs, lg, self.pc, self.pc.c * time, self.dtype,
                device)
            # the next step's stream: n00 <- np1, nm1 <- n00
            st["laser_out"] = tuple(torch.empty(
                (nz,) + lg.slice_shape, dtype=lz.complex_dtype(self.dtype),
                device=device) for _ in range(2))
        if cfg.salame_active:
            carry["salame"] = empty_salame_state(g, device, self.dtype)
            # the slices SALAME runs on: step 0's that hold a SALAME lane,
            # one read of the device at step 0 (the JAX package decides each
            # slice on the device)
            is_sal = torch.zeros(nz, dtype=torch.bool, device=device)
            if step == 0:
                is_sal = bm.salame_lanes(binned, self.beam_cfgs).any(dim=1)
                with span("read: SALAME slices"):
                    carry["salame_slices"] = is_sal.tolist()
            else:
                carry["salame_slices"] = [False] * nz
            st["is_sal"] = is_sal
        # the sweep's device buffers, one row per slice
        bufs = {}
        if cfg.salame_active:
            bufs["salame_W"] = torch.zeros(nz, **dev)
            bufs["salame_dbg"] = torch.zeros((nz, 4), **dev)
        if cfg.diag_comps:
            bufs["diag"] = torch.empty((nz, len(cfg.diag_comps), g.ny, g.nx),
                                       **dev)
        int_diags = {}
        for dg in cfg.diags:
            dgeom = self._diag_base_geom(dg)
            kw = (dict(dev, dtype=lz.complex_dtype(self.dtype))
                  if "laserEnvelope" in dg.comps else dev)
            if dg.diag_type == "xy_integrated":
                int_diags[dg.name] = torch.zeros(diag_slice_shape(dg, dgeom),
                                                 **kw)
            elif not is_full_interior(dg, g):
                # a fine level's rows stay zero on the slices it does not
                # run (outside its z range, which its output never reads)
                bufs["diagf_" + dg.name] = torch.zeros(
                    (nz,) + diag_slice_shape(dg, dgeom), **kw)
        if int_diags:
            carry["diag_int"] = int_diags
        if cfg.insitu_beam_period and cfg.beams:
            bufs["insitu_beam"] = torch.empty(
                (nz, len(cfg.beams), len(ins.BEAM_ORDER)), **dev)
        if cfg.insitu_plasma_period:
            bufs["insitu_plasma"] = torch.empty(
                (nz, len(self.plasma_cfgs), len(ins.PLASMA_ORDER)), **dev)
        if cfg.insitu_field_period and cfg.explicit:
            bufs["insitu_field"] = torch.empty(
                (nz, len(ins.FIELD_NAMES)), **dev)
        if cfg.use_laser and cfg.insitu_laser_period:
            bufs["insitu_laser"] = torch.empty((nz, 8), **dev)
        st.update(carry=carry, bufs=bufs, int_diags=list(int_diags))
        return st

    def sweep_slice(self, st: dict, islice: int, this: dict, nxt: dict,
                    laser_rows=None) -> dict:
        """Slice islice of a step_state's sweep from the beam lanes this
        (the slice's) and nxt (the next slice's), with a laser its (n00,
        nm1) rows of the stream: the slice step, its outputs into the
        state's buffers. Returns the lanes it emitted."""
        slice_step = st["slice_step"]
        with span("slice step", step=st["carry"]["step"], slice=islice,
                  device=slice_step.device):
            carry, out = slice_step(st["carry"], islice, this, nxt,
                                    laser_rows)
            st["carry"] = carry
            with span("diagnostics"):
                for k, buf in st["bufs"].items():
                    if k in out:
                        buf[islice] = out[k]
            for k, v in out.items():
                if k == "salame_cycles" or k.startswith("mg_cycles_lev"):
                    st["extra_cycles"].setdefault(k, {})[islice] = v
            st["cycles"].append(out["mg_cycles"])
            st["pc_iters"].append(out["pc_iters"])
            st["pc_err"].append(out["pc_err"])
            if self.cfg.use_laser:
                with span("laser: stream rows"):
                    st["laser_out"][0][islice] = out["laser_np1"]
                    st["laser_out"][1][islice] = out["laser_n00"]
                st["laser_cycles"].append(out["laser_cycles"])
        return out["beam_out"]

    @staticmethod
    def read_step_counts(*states) -> None:
        """The kernels leave their V-cycle counts on the device: read those
        of every state's sweep at once, after the sweeps."""
        _read_counts(*[grp for st in states for grp in (
            st["cycles"], st["laser_cycles"], *st["extra_cycles"].values())])

    def step_result(self, st: dict) -> dict:
        """A swept step_state's result, as _time_step's but for binned (the
        counts read by read_step_counts)."""
        cfg, carry, bufs = self.cfg, st["carry"], st["bufs"]
        res = {"diag": bufs.get("diag", torch.empty(
                   (self.geom.nz, 0), dtype=self.dtype,
                   device=carry["time"].device)),
               "mg_cycles": st["cycles"], "pc_iters": st["pc_iters"],
               "pc_err": st["pc_err"]}
        res.update((k, v) for k, v in bufs.items() if k != "diag")
        res.update(st["extra_cycles"])
        if cfg.salame_active:
            res["salame_is_sal"] = st["is_sal"]
        for name in st["int_diags"]:
            res["diag_int_" + name] = carry["diag_int"][name]
        if cfg.use_laser:
            res["laser_stream"] = st["laser_out"]
            res["laser_cycles"] = st["laser_cycles"]
        if cfg.adaptive_dt:
            res["beam_moments"] = carry["beam_moments"]
            res["min_uz"] = carry["min_uz"]
        if cfg.ionization_pairs:
            # the step's ionization events: each raised a lane's level by
            # one from the species' start; a 0-d device tensor
            res["ionized"] = sum(
                torch.clamp(carry["plasma"][ip]["ion_lev"]
                            - self.plasma_cfgs[ip].init_ion_lev, min=0).sum()
                for ip, *_ in cfg.ionization_pairs)
        res["plasma"] = carry["plasma"]
        return res

    def _time_step(self, binned: dict, time: float, dt: float,
                   step: int = 0, laser_stream=None) -> dict:
        """One full time step: plasma re-init, neutralizing background, the
        slice sweep from the head (last slice) to the tail, re-binning.
        mg_cycles, pc_iters and pc_err hold one entry per slice in sweep
        order, head first; with a laser laser_cycles too, and laser_stream
        the next step's (n00, nm1); under adaptive dt beam_moments and
        min_uz, 0-d device tensors; plasma, each species' state after the
        sweep; with ionization ionized, the step's ionization events, a
        0-d device tensor; with SALAME salame_W and salame_dbg per slice,
        salame_is_sal (which slices ran it) and salame_cycles (per SALAME
        slice); with mesh refinement mg_cycles_lev<N> (per slice the level
        runs, explicit solver)."""
        g, nz = self.geom, self.geom.nz
        with span("time step", step=step, device=self.device):
            st = self.step_state(time, dt, step, self.slice_step,
                                 self.device, binned)
            if self.cfg.use_laser and laser_stream is None:
                zc = torch.zeros_like(st["laser_out"][0])
                laser_stream = (zc, zc)
            beam = {k: binned[k] for k in bm.ALL_ATTRS}
            empty_next = {k: torch.zeros_like(v[0]) for k, v in beam.items()}
            emitted = [None] * nz
            for islice in range(nz - 1, -1, -1):
                this = {k: v[islice] for k, v in beam.items()}
                nxt = ({k: v[islice - 1] for k, v in beam.items()} if islice
                       else empty_next)
                rows = ((laser_stream[0][islice], laser_stream[1][islice])
                        if self.cfg.use_laser else None)
                emitted[islice] = self.sweep_slice(st, islice, this, nxt,
                                                   rows)
            self.read_step_counts(st)
            res = self.step_result(st)
            # merge emitted beam + final slip, re-bin by new z
            with span("re-bin"):
                flat = {k: torch.cat([e[k] for e in emitted]
                                     + [st["carry"]["slip"][k]])
                        for k in bm.ALL_ATTRS}
                res["binned"] = bm.bin_beam(flat, g, self.beam_cap)
        return res

    def run_step(self, step: int) -> dict:
        """One time step from the simulation's state; the laser stream
        advances with it."""
        res = self._time_step(self.binned, self.time, self.dt, step,
                              self.laser_stream)
        if self.cfg.use_laser:
            self.laser_stream = res["laser_stream"]
        return res

    def apply_density_table(self) -> None:
        """Give each plasma with a density table the expression for the
        current c*t (ref parameters.rst:405-411), as the JAX package's time
        loop does before each step."""
        cfgs = tuple(dataclasses.replace(
            p, density_expr=p.density_at(self.pc.c * self.time))
            for p in self.plasma_cfgs)
        if cfgs != self.plasma_cfgs:
            self.plasma_cfgs = cfgs
            self.cfg = dataclasses.replace(self.cfg, plasmas=cfgs)
            self.slice_step.cfg = self.cfg

    def set_dt(self) -> None:
        """dt before a step: the adaptive phase-advance control, then the
        landing on hipace.max_time (the step AT max_time runs once with
        dt = 0 and ends the run; ref Hipace.cpp:424-435)."""
        if self.adt_cfg.enabled:
            self.dt = adt.calculate_from_density(
                self.adt_cfg, self.plasma_cfgs, self.pc, self.time, self.dt,
                self.min_uz_mq)
        if self.time == self.max_time:
            self._has_last_step = True
            self.dt = 0.0
        elif self._crosses_max_time(self.time, self.dt):
            self.dt = self.max_time - self.time

    def _crosses_max_time(self, t: float, dt: float) -> bool:
        """A step from time t at dt reaches or passes hipace.max_time."""
        return (t + dt >= self.max_time > t) or (t + dt <= self.max_time < t)

    @staticmethod
    def _moment_values(res: dict) -> list:
        """A step's beam moments for the next dt: sum_w, sum_w_uz,
        sum_w_uz2 and min_uz, one read of four device scalars."""
        mom = res["beam_moments"]
        with span("read: beam moments"):
            return torch.stack([mom["sum_w"], mom["sum_w_uz"],
                                mom["sum_w_uz2"], res["min_uz"]]).tolist()

    def _next_dt(self, vals: list, numprocs: int = 1) -> None:
        """The next dt from a step's beam moments (_moment_values), predicted
        numprocs steps ahead (the first beam's mass and charge, as the JAX
        package takes them, ROADMAP R4)."""
        self.dt, self.min_uz_mq = adt.calculate_from_min_uz(
            self.adt_cfg, dict(zip(("sum_w", "sum_w_uz", "sum_w_uz2",
                                    "min_uz"), vals), min_acc=0.0),
            self.beam_cfgs[0], self.plasma_cfgs, self.pc, self.time,
            self.dt, numprocs=numprocs)

    def advance(self, step: int, write_output: bool = True) -> dict:
        """One step of the time loop after set_dt: the density table's
        expressions, the step, its output (from the beam as it was before
        the step's push), the pushed beam and the time, then, under adaptive
        dt, the next dt from the step's beam moments (_next_dt)."""
        self.apply_density_table()
        pre_push_binned = self.binned
        res = self.run_step(step)
        if write_output:
            with span("output", step=step):
                self.write_output(step, res, pre_push_binned)
        self.binned = res["binned"]
        self.time += self.dt
        if (self.adt_cfg.enabled and self.beam_cfgs
                and not self._has_last_step):
            self._next_dt(self._moment_values(res))
        return res

    def evolve(self, write_output: bool = True, start_step: int = 0):
        """Time loop (ref Hipace.cpp:393-507) from start_step."""
        for step in range(start_step, self.max_step + 1):
            self.set_dt()
            if self.verbose >= 1:
                print(f"Rank 0 started step {step} at time {self.time}"
                      f" with dt {self.dt}")
            self.advance(step, write_output)
            if self._has_last_step:
                break
        return self

    def stage_slice_steps(self, devices) -> list:
        """One SliceStep per pipeline stage, on its device, each drawing its
        uniforms from a generator of its own (its solvers, beam constants
        and K3's device-side V-cycle counts are its own too, also where
        stages share a device); made once per device list and
        configuration."""
        key = tuple(str(d) for d in devices)
        cached = getattr(self, "_stage_steps", None)
        if cached is None or cached[0] != key or cached[1] is not self.cfg:
            steps = [SliceStep(self.cfg, d, self.dtype, UniformDraws(
                torch.Generator(device=d), d, self.dtype)) for d in devices]
            self._stage_steps = cached = (key, self.cfg, steps)
        return cached[2]

    def _stage_device(self, device) -> torch.device:
        """A pipeline stage's device, held to the device policy (a CUDA
        device without a GPU raises) and to the simulation's device type."""
        dev, _ = dev_policy.resolve(device, self.dtype)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type != self.device.type:
            raise ValueError(f"pipeline stage on {dev}: the simulation runs "
                             f"on {self.device}")
        return dev

    def _window_ladder(self, step: int, n: int) -> tuple:
        """The dt/time ladder of the window of n steps from `step`, on the
        host from the simulation's time and dt (ref
        AdaptiveTimeStep.cpp:338-370): under adaptive dt the phase-advance
        control per step. (None, None) where the loop finishes serially:
        fewer than n steps are left, or hipace.max_time falls inside the
        window."""
        if self.max_step - step + 1 < n:
            return None, None
        dts, times = [], []
        t, dt = self.time, self.dt
        for _ in range(n):
            if self.adt_cfg.enabled:
                dt = adt.calculate_from_density(
                    self.adt_cfg, self.plasma_cfgs, self.pc, t, dt,
                    self.min_uz_mq)
            if t == self.max_time or self._crosses_max_time(t, dt):
                return None, None
            dts.append(dt)
            times.append(t)
            t += dt
        return dts, times

    def evolve_pipelined(self, devices=None, write_output: bool = True):
        """The time loop as a temporal pipeline (ref Hipace.cpp:400-401, the
        reference's mpiexec -n N mode): windows of n = len(devices)
        consecutive steps, stage d of a window running step base + d on
        devices[d] (parallel/pipeline.py), with every step's openPMD and
        in-situ output written in step order from its stage's buffers, at
        that stage's time and dt. A window's dt/time ladder is predicted on
        the host (ref AdaptiveTimeStep.cpp:338-370): under adaptive dt the
        phase-advance control per stage, then the next window's dt from the
        last stage's beam moments with numprocs = n.

        devices: a list of devices of the simulation's type, which may
        repeat one device (several stages on one card, or the CPU); by
        default every CUDA device on the card, the simulation's own on the
        CPU. It runs the serial loop where n <= 1 or a plasma has a density
        table, and finishes serially from the step where fewer than n steps
        are left or a window would cross hipace.max_time. One host thread
        drives every stage, so the stages run one after another, at about
        the serial loop's rate; evolve_ranks runs them at the same time, one
        process per stage."""
        from ..parallel.pipeline import pipelined_window
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        devices = [self._stage_device(d) for d in devices]
        n = len(devices)
        if n <= 1 or any(p.density_table for p in self.plasma_cfgs):
            return self.evolve(write_output)
        step = 0
        while step <= self.max_step:
            dts, times = self._window_ladder(step, n)
            if dts is None:
                return self.evolve(write_output, start_step=step)
            if self.verbose >= 1:
                for d in range(n):
                    print(f"Rank {d} started step {step + d} at time "
                          f"{times[d]} with dt {dts[d]}")
            win = pipelined_window(self, self.binned, dts, times, step,
                                   devices, self.laser_stream)
            for d in range(n):
                self.time, self.dt = times[d], dts[d]
                if write_output:
                    self.write_output(step + d, win["stages"][d],
                                      win["inputs"][d])
            self.binned = bm.bin_beam(
                {k: v.to(self.device) for k, v in win["beam"].items()},
                self.geom, self.beam_cap)
            if self.cfg.use_laser:
                self.laser_stream = tuple(a.to(self.device)
                                          for a in win["laser_stream"])
            self.time = times[-1] + dts[-1]
            if self.adt_cfg.enabled and self.beam_cfgs:
                self._next_dt(self._moment_values(win["stages"][-1]),
                              numprocs=n)
            del win     # its stages' buffers, before the next window's
            step += n
        return self

    def evolve_ranks(self, ring, write_output: bool = True):
        """evolve_pipelined's time loop as one rank of a ring of processes
        (parallel/ranks.py; the reference's MPI ranks, ref
        Hipace.cpp:400-401): rank d = ring.rank runs step base + d of each
        window of n = ring.size steps on its own device, at the same time as
        the other ranks, with the same windows, dt/time ladder and results
        as evolve_pipelined over n devices. Every rank builds the window's
        ladder from the same state; under adaptive dt rank n - 1 broadcasts
        its beam moments once per window. Rank d writes step base + d's
        openPMD file; rank 0 gathers every rank's in-situ records and
        appends them in step order. The serial fallbacks (a density table,
        fewer than n steps left, hipace.max_time inside a window) run on
        rank 0 from its state, after every rank has met at a barrier, and
        the other ranks return. Rank 0 holds the final beam and time."""
        from ..parallel.ranks import rank_window
        n, d = ring.size, ring.rank
        step = 0
        while step <= self.max_step:
            dts, times = ((None, None) if n <= 1 or any(
                p.density_table for p in self.plasma_cfgs)
                else self._window_ladder(step, n))
            if dts is None:
                ring.barrier()
                return (self.evolve(write_output, start_step=step) if d == 0
                        else self)
            if self.verbose >= 1:
                # one write per line: the ranks share their output
                print(f"Rank {d} started step {step + d} at time {times[d]}"
                      f" with dt {dts[d]}\n", end="", flush=True)
            win = rank_window(self, ring, self.binned, dts, times, step,
                              self.laser_stream)
            self.time, self.dt = times[d], dts[d]
            if write_output:
                if self._do_output(step + d):
                    self._write_diagnostics(step + d, win["stage"],
                                            win["input"])
                records = ring.gather_objects(
                    self._insitu_records(step + d, win["stage"]))
                for recs in records or ():
                    self._write_records(recs)
            if d == 0:
                self.binned = bm.bin_beam(win["beam"], self.geom,
                                          self.beam_cap)
                if self.cfg.use_laser:
                    self.laser_stream = win["laser_stream"]
            self.time, self.dt = times[-1] + dts[-1], dts[-1]
            if self.adt_cfg.enabled and self.beam_cfgs:
                # rank n - 1 reads its step's moments for every rank
                self._next_dt(ring.broadcast_floats(
                    self._moment_values(win["stage"]) if d == n - 1
                    else None, 4, src=n - 1), numprocs=n)
            del win     # its step's buffers, before the next window's
            step += n
        return self

    # ------------------------------------------------------------------
    def _period_hit(self, period: int, step: int) -> bool:
        last = step == self.max_step or self._has_last_step
        if period < 0:
            return last
        if period == 0:
            return False
        return (step % period == 0) or last

    def _do_output(self, step: int) -> bool:
        return (any(self._period_hit(dg.period, step) for dg in self.diags)
                or (bool(self.beam_data)
                    and self._period_hit(self.beam_output_period, step)))

    def write_output(self, step: int, res: dict, pre_push_binned: dict):
        """The step's openPMD file (where a period hits) and in-situ
        records."""
        if self._do_output(step):
            self._write_diagnostics(step, res, pre_push_binned)
        self._write_insitu(step, res)

    def _write_insitu(self, step, res):
        """Write reduced diagnostics (ref Hipace.cpp:487-490)."""
        self._write_records(self._insitu_records(step, res))

    def _write_records(self, records: list) -> None:
        """Append in-situ records (_insitu_records') to their files, one
        writer per record kind and name."""
        for kind, name, key, default_prefix, rec in records:
            wkey = (kind, name)
            if wkey not in self._insitu_writers:
                self._insitu_writers[wkey] = ins.InsituWriter(
                    self.inputs.query(key, default_prefix, str), name)
            self._insitu_writers[wkey].write_record(rec)

    def _insitu_records(self, step, res) -> list:
        """A step's in-situ records at the simulation's time, where their
        periods hit: (kind, name, deck key of the file prefix, its default,
        record) each, in the order they are written."""
        cfg, g = self.cfg, self.geom
        out = []
        if "insitu_beam" in res and step % cfg.insitu_beam_period == 0:
            moments = res["insitu_beam"].cpu().numpy()[..., ins.BEAM_ORDER]
            for ib, b in enumerate(self.beam_cfgs):
                out.append(("beam", b.name, f"{b.name}.insitu_file_prefix",
                            "diags/insitu", ins.beam_record(
                                step, self.time, moments[:, ib], b.charge,
                                b.mass, g, self.normalized_units)))
        if "insitu_field" in res and step % cfg.insitu_field_period == 0:
            moments = res["insitu_field"].cpu().numpy() * (
                g.dx * g.dy * g.dz)
            out.append(("field", "field", "fields.insitu_file_prefix",
                        "diags/field_insitu", ins.field_record(
                            step, self.time, moments, g,
                            self.normalized_units)))
        if "insitu_laser" in res and step % cfg.insitu_laser_period == 0:
            out.append(("laser", "laser", "lasers.insitu_file_prefix",
                        "diags/laser_insitu", ins.laser_record(
                            step, self.time,
                            res["insitu_laser"].cpu().numpy(), g,
                            self.normalized_units)))
        if "insitu_plasma" in res and step % cfg.insitu_plasma_period == 0:
            moments = res["insitu_plasma"].cpu().numpy()[
                ..., ins.PLASMA_ORDER]
            for i, p in enumerate(self.plasma_cfgs):
                out.append(("plasma", p.name, f"{p.name}.insitu_file_prefix",
                            "diags/plasma_insitu", ins.plasma_record(
                                step, self.time, moments[:, i], p.charge,
                                p.mass, g, self.normalized_units)))
        return out

    @staticmethod
    def _z_process(arr, dg):
        """Host-side z patch crop + coarsening on a z-leading stack."""
        z0, z1 = dg.patch_z
        arr = arr[z0:z1 + 1]
        cz = dg.coarsening[2]
        if cz > 1:
            n = (arr.shape[0] // cz) * cz
            arr = arr[:n]
            if cz % 2 == 1:
                arr = arr[cz // 2::cz]
            else:
                arr = 0.5 * (arr[cz // 2 - 1::cz] + arr[cz // 2::cz])
        return arr

    def _diag_geometry(self, dg):
        """(spacing, offset) per written axis, reference layout z, y, x; a
        diagnostic on a separate laser grid or a fine level takes its
        transverse ones."""
        g = self.geom
        fg = self._diag_base_geom(dg)
        cx, cy, cz = dg.coarsening
        return ((g.dz * cz, fg.dy * cy, fg.dx * cx),
                (g.prob_lo[2] + dg.patch_z[0] * g.dz,
                 fg.prob_lo[1] + dg.patch_y[0] * fg.dy,
                 fg.prob_lo[0] + dg.patch_x[0] * fg.dx))

    def _write_diagnostics(self, step: int, res, pre_binned):
        """Per-diag processing + openPMD write (ref OpenPMDWriter.cpp)."""
        diag = None
        fields = {}
        field_meta = {}
        for dg in self.diags:
            if not self._period_hit(dg.period, step):
                continue
            spacing, offset = self._diag_geometry(dg)

            def key(c):
                return f"{dg.name}/{c}" if dg.name != "lev0" else c

            if is_full_interior(dg, self.geom):
                if diag is None:
                    diag = res["diag"].cpu().numpy()
                for c in dg.comps:
                    fields[key(c)] = self._z_process(
                        diag[:, self.cfg.diag_comps.index(c)], dg)
                    field_meta[key(c)] = (spacing, offset)
                continue
            if dg.diag_type == "xy_integrated":
                arr = res["diag_int_" + dg.name].cpu().numpy() * self.geom.dz
                for ic, c in enumerate(dg.comps):
                    fields[key(c)] = arr[ic]
                    field_meta[key(c)] = ((spacing[1], spacing[2]),
                                          (offset[1], offset[2]), ("y", "x"))
                continue
            arr = self._z_process(res["diagf_" + dg.name].cpu().numpy(), dg)
            for ic, c in enumerate(dg.comps):
                fields[key(c)] = arr[:, ic]
                if dg.diag_type == "xz":
                    field_meta[key(c)] = ((spacing[0], spacing[2]),
                                          (offset[0], offset[2]), ("z", "x"))
                elif dg.diag_type == "yz":
                    field_meta[key(c)] = ((spacing[0], spacing[1]),
                                          (offset[0], offset[1]), ("z", "y"))
                else:
                    field_meta[key(c)] = (spacing, offset)

        beams = {}
        if self.beam_data and self._period_hit(self.beam_output_period,
                                               step):
            valid = pre_binned["valid"].reshape(-1).cpu().numpy()
            bid = pre_binned["beam_id"].reshape(-1).cpu().numpy()
            for ib, bcfg in enumerate(self.beam_cfgs):
                if bcfg.name not in self.beam_data:
                    continue
                keep = valid & (bid == ib)
                bout = {k: pre_binned[k].reshape(-1).cpu().numpy()[keep]
                        for _, k in BEAM_RECORDS}
                # openPMD momenta are dimensionless gamma*beta (ref
                # OpenPMDWriter.H:79-95); stored momenta are u*c
                for k in ("ux", "uy", "uz"):
                    bout[k] = bout[k] / self.pc.c
                beams[bcfg.name] = bout
        self.writer.write(step, self.time, self.dt, fields, self.geom,
                          beams=beams, field_meta=field_meta)
