"""SALAME beam loading: the slice-by-slice iteration on beam weights.

Port of ``hipace_tpu/pipeline/salame.py`` (ref src/salame/Salame.cpp,
called from Hipace.cpp:673-678). At step 0, on each slice that holds lanes
of a beam with ``do_salame``, the weights of those lanes are iterated so
that the Ez they sample stays at the target, by default the Ez of the first
SALAME slice (Slicing Advanced Loading And Matching of Electrons). It runs
after the level-0 Bx/By solve of the explicit solver.

Each of the ``hipace.salame_n_iter`` iterations solves Ez without the extra
SALAME weight (a temporary plasma push, K2, its jx/jy deposit, K1, and one
DST solve) and the Ez of the SALAME beam alone (its jz, K1, its Bx/By
through K3 at most 40 V-cycles, then the plasma's response to that B, by
the temporary momenta of ``hipace.salame_do_advance`` (K2, K1) or by chi,
and one DST solve). The jz-weighted averages of the target, the first and
the second Ez give the weight factor W; then the slice's jz is deposited
again with the new weights (K1) and its Bx/By solved again (K3). The flags,
the sums and W stay 0-d tensors on the slice's device: every iteration
runs, as in the JAX package (convergence freezes W at 1 and does not leave
the loop), and nothing is read back to the host.

The plasma's own Sx/Sy, which every iteration adds back, come from the
coefficient grids of the fused level-0 deposit (``combine_explicit_sxsy``
on zero Sx/Sy) instead of a second deposit.
"""

from __future__ import annotations

import torch

from ..fields import slices as sl
from ..particles import beam as bm
from ..particles import plasma as pl


def empty_salame_state(geom, device, dtype) -> dict:
    """The SALAME carry before the first slice."""
    z = dict(dtype=dtype, device=device)
    return {"ez_target": torch.zeros(geom.slice_shape, **z),
            "zeta_initial": torch.zeros((), **z),
            "prev_was_salame": torch.zeros((), dtype=torch.bool,
                                           device=device),
            "overloaded": torch.zeros((), dtype=torch.bool, device=device),
            "W_last": torch.zeros((), **z),
            "dbg": torch.zeros((4,), **z)}


def salame_slice(cfg, this: dict, f_next: dict, f_prev: dict, plasmas: list,
                 dgrids_list: list, beam_this: dict, sal_state: dict,
                 islice: int, solver, mg, target_fn, charges=None):
    """One SALAME slice (ref Salame.cpp:13-189). this: the slice's level-0
    fields after its Bx/By solve; f_next/f_prev: the Next and Previous beam
    currents; plasmas: the species after their deposit, dgrids_list their
    fused deposit's coefficient grids; target_fn: the deck's
    salame_Ez_target(zeta, zeta_initial, Ez_initial). Returns (this,
    beam_this with the new weights, sal_state)."""
    g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
    dz = g.dz
    dev = dict(dtype=this["Ez"].dtype, device=this["Ez"].device)
    sal_mask = bm.salame_lanes(beam_this, cfg.beams)

    # Ez_target and zeta_initial are taken on the first slice of a block
    fresh = ~sal_state["prev_was_salame"]
    zeta = torch.full((), g.prob_lo[2] + (islice + 0.5) * dz, **dev)
    ez_target = torch.where(fresh, this["Ez"], sal_state["ez_target"])
    zeta_initial = torch.where(fresh, zeta, sal_state["zeta_initial"])
    zeta_next = torch.full((), g.prob_lo[2] + (islice - 0.5) * dz, **dev)

    # the plasma-only Sx/Sy (ref Salame.cpp:32-39)
    sx_sy = dict(this, Sx=torch.zeros_like(this["Sx"]),
                 Sy=torch.zeros_like(this["Sy"]))
    for dg in dgrids_list:
        sx_sy = pl.combine_explicit_sxsy(sx_sy, dg, pc, g)
    sy_back = sl.interior(sx_sy["Sy"], g)
    sx_back = sl.interior(sx_sy["Sx"], g)

    w_beam = beam_this["w"]
    overloaded = sal_state["overloaded"]
    converged = torch.zeros((), dtype=torch.bool, device=dev["device"])
    chi_i = sl.interior(this["chi"], g)
    zero = torch.zeros_like(this["Ez"])

    def solve_ez(jx, jy):
        rhs = (sl.ddx_interior(jx, g) + sl.ddy_interior(jy, g)) \
            / (pc.ep0 * pc.c)
        return sl.set_interior(zero, solver.solve(rhs[None])[0], g)

    cycles = []

    def solve_bxby(b0, sy, sx):
        b = mg.solve(b0, torch.stack([sy, sx]), chi_i,
                     tol_rel=cfg.MG_tolerance_rel,
                     tol_abs=cfg.MG_tolerance_abs, max_iters=40)
        cycles.append(mg.cycles)
        return b

    for _ in range(cfg.salame_n_iter):
        # STEP 1: Ez without the extra SALAME weight (the plasma's response
        # and the beam's currents)
        p_tmps = [pl.advance_plasma(p, this, g, pcfg, pc, order=order,
                                    temp_slice=True, use_laser=cfg.use_laser)
                  for p, pcfg in zip(plasmas, cfg.plasmas)]
        dep = {"jx": f_next["jx_beam"], "jy": f_next["jy_beam"]}
        for p_tmp, pcfg in zip(p_tmps, cfg.plasmas):
            dep, _ = pl.deposit_plasma(p_tmp, ["jx", "jy"], dep, g, pcfg, pc,
                                       order, cfg.normalized_units)
        ez_no_salame = solve_ez(dep["jx"], dep["jy"])

        # STEP 2: Ez of the SALAME beam alone
        jzb = bm.deposit_beam_slice(
            dict(beam_this, w=w_beam), {"jz": "jz_beam"},
            {"jz_beam": torch.zeros_like(zero)}, g, cfg.beams, pc, order,
            cfg.normalized_units, charges, only_salame=True)["jz_beam"]
        # Sy = -mu0 dy jzb, Sx = +mu0 dx jzb (ref Salame.cpp:192-225)
        b = solve_bxby(torch.zeros((2,) + chi_i.shape, **dev),
                       -pc.mu0 * sl.ddy_interior(jzb, g),
                       pc.mu0 * sl.ddx_interior(jzb, g))
        bx_sal = sl.set_interior(zero, b[0], g)
        by_sal = sl.set_interior(zero, b[1], g)
        if cfg.salame_do_advance:
            # SalameOnlyAdvancePlasma (ref Salame.cpp:262-338): momenta from
            # the SALAME-only B at the lanes' previous positions (K2 with
            # the other planes zero), deposited at the temporary positions
            dep2 = {"jx": torch.zeros_like(zero), "jy": torch.zeros_like(zero)}
            planes = [zero, zero, bx_sal, by_sal, zero]
            for p, p_tmp, pcfg in zip(plasmas, p_tmps, cfg.plasmas):
                _, _, _, bx_p, by_p, _ = pl.gather_fields(
                    planes, p["x_prev"], p["y_prev"], p["valid"], g, order)
                q_m = pcfg.charge / pcfg.mass
                if pcfg.can_ionize:
                    q_m = q_m * p["ion_lev"].to(bx_p.dtype)
                p_sal = dict(p_tmp, ux=1.5 * dz * q_m * by_p,
                             uy=-1.5 * dz * q_m * bx_p)
                dep2, _ = pl.deposit_plasma(p_sal, ["jx", "jy"], dep2, g,
                                            pcfg, pc, order,
                                            cfg.normalized_units)
        else:
            # jx = dz chi By / mu0, jy = -dz chi Bx / mu0 (Salame.cpp:228-259)
            dep2 = {"jx": 1.5 * dz * this["chi"] * by_sal / pc.mu0,
                    "jy": -1.5 * dz * this["chi"] * bx_sal / pc.mu0}
        ez_only_salame = solve_ez(dep2["jx"], dep2["jy"])

        # STEP 3: the weight factor W (ref Salame.cpp:341-420)
        jz_i = sl.interior(jzb, g)
        sum_jz = torch.sum(jz_i)
        sum_jz_safe = torch.where(sum_jz == 0.0, torch.ones_like(sum_jz),
                                  sum_jz)
        avg_t = torch.sum(jz_i * sl.interior(ez_target, g)) / sum_jz_safe
        avg_n = torch.sum(jz_i * sl.interior(ez_no_salame, g)) / sum_jz_safe
        avg_o = torch.sum(jz_i * sl.interior(ez_only_salame, g)) / sum_jz_safe
        avg_t = target_fn(zeta_next, zeta_initial, avg_t)
        avg_o_safe = torch.where(avg_o == 0.0, torch.ones_like(avg_o), avg_o)
        W = (avg_t - avg_n) / avg_o_safe + 1.0
        bad = (W < 0.0) | overloaded
        W = torch.where(bad | converged,
                        torch.where(bad, torch.zeros_like(W),
                                    torch.ones_like(W)), W)
        overloaded = overloaded | bad
        converged = converged | (torch.abs(W - 1.0) < cfg.salame_tolerance)
        w_beam = torch.where(sal_mask, w_beam * W, w_beam)

        # STEP 4: this slice's jz (every beam) with the new weights, its
        # Sx/Sy with the plasma's, and Bx/By again
        this = dict(this, jz_beam=bm.deposit_beam_slice(
            dict(beam_this, w=w_beam), {"jz": "jz_beam"},
            {"jz_beam": torch.zeros_like(zero)}, g, cfg.beams, pc, order,
            cfg.normalized_units, charges)["jz_beam"])
        dz2_inv = 1.0 / (2.0 * dz)
        dz_jxb = (sl.interior(f_prev["jx_beam"], g)
                  - sl.interior(f_next["jx_beam"], g)) * dz2_inv
        dz_jyb = (sl.interior(f_prev["jy_beam"], g)
                  - sl.interior(f_next["jy_beam"], g)) * dz2_inv
        sy_new = pc.mu0 * (-sl.ddy_interior(this["jz_beam"], g) + dz_jyb) \
            + sy_back
        sx_new = -pc.mu0 * (-sl.ddx_interior(this["jz_beam"], g) + dz_jxb) \
            + sx_back
        b0 = torch.stack([sl.interior(this["Bx"], g),
                          sl.interior(this["By"], g)])
        b = solve_bxby(b0, sy_new, sx_new)
        this = dict(this, Sy=sl.set_interior(this["Sy"], sy_new, g),
                    Sx=sl.set_interior(this["Sx"], sx_new, g),
                    Bx=sl.set_interior(this["Bx"], b[0], g),
                    By=sl.set_interior(this["By"], b[1], g))

    sal_state = {"ez_target": ez_target, "zeta_initial": zeta_initial,
                 "prev_was_salame": torch.ones_like(fresh),
                 "overloaded": overloaded, "W_last": W,
                 "dbg": torch.stack([avg_t, avg_n, avg_o, sum_jz])}
    return this, dict(beam_this, w=w_beam), sal_state, cycles
