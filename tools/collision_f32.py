"""What float32 does to the JAX package's Coulomb collisions, on the CPU.

    JAX_PLATFORMS=cpu python tools/collision_f32.py [--nxy 64]

Runs ``hipace_tpu/particles/collisions.py`` as the JAX package's float32
runs would: with x64 off (float32 arrays, float32 draws), on one slice of
``COLLISION_WAKE``'s shape (the flagship's normalized 1 ppc electron plasma
with ``hipace.background_density_SI = 1e24``, a drive beam of uz 2000 in the
middle cells), and then the same in float64 in a second process with x64
on. For each it prints the same-species collision's non-finite momenta and
the beam-plasma collision's largest kicks, and for float32 the guards and
products of ``_pair_kick`` that leave float32's range: ``tiny = 1e-300``
rounds to 0, so ``p1sm_safe`` is 0 where two lanes' momenta are equal and
the division by it is inf or NaN; n1 n2 ~ 1e48 m^-6 overflows to inf while
q_e^4 (normalized units) or q1^2 q2^2 (SI) underflows to 0, so s is NaN and
every pair takes the isotropic branch of the scattering angle; m1 m2 ~ 8e-61
kg^2 underflows to 0 in the Coulomb logarithm's and s's factors. The port
computes the same formulas and gives the same (``chip_smoke.py``'s collision
path prints its float32 kicks on the card). Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(nxy: int, x64: bool) -> None:
    import jax
    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from hipace_tpu import constants as cst
    from hipace_tpu.parser import Inputs
    from hipace_tpu.particles import collisions as jc
    from hipace_tpu.particles.beam import BeamConfig
    from hipace_tpu.particles.plasma import PlasmaConfig, init_plasma
    from hipace_tpu.geometry import Geometry
    dtype = jnp.float64 if x64 else jnp.float32
    deck = Inputs(f"amr.n_cell = {nxy} {nxy} 8\nhipace.normalized_units = 1\n"
                  "geometry.prob_lo = -8. -8. -6.\n"
                  "geometry.prob_hi = 8. 8. 2.\nbeam.injection_type = "
                  "fixed_weight\nbeam.num_particles = 1000\n"
                  "beam.density = 3.\n")
    geom = Geometry.from_inputs(deck)
    pc = cst.NORMALIZED
    pcfg = PlasmaConfig.from_inputs(deck, "plasma", pc, "Periodic")
    bcfg = BeamConfig.from_inputs(deck, "beam", pc, geom, True)
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v) for k, v in init_plasma(
        pcfg, geom, jax.random.PRNGKey(0), dtype, 0.0, True).items()}
    n = p["x"].size
    # a wake's plasma: lanes moved by up to a cell, small momenta, and the
    # lanes ahead of the beam (a tenth) still at rest
    moving = rng.uniform(size=n) > 0.1
    for k in ("x", "y"):
        p[k] = p[k] + moving * rng.uniform(-1, 1, n) * geom.dx
    u = 0.05 * rng.standard_normal((3, n)) * moving
    p["ux"], p["uy"] = u[0], u[1]
    p["psi"] = np.sqrt(1 + (u ** 2).sum(0)) - u[2]
    nb = 20000
    b = {"x": 0.3 * rng.standard_normal(nb), "y": 0.3 * rng.standard_normal(nb),
         "ux": 0.1 * rng.standard_normal(nb), "uy": 0.1 * rng.standard_normal(nb),
         "uz": 2000 + rng.standard_normal(nb), "w": np.full(nb, 1e-3),
         "valid": np.ones(nb, bool)}
    p = {k: jnp.asarray(v, dtype if v.dtype.kind == "f" else None)
         for k, v in p.items()}
    b = {k: jnp.asarray(v, dtype if v.dtype.kind == "f" else None)
         for k, v in b.items()}
    q, _ = jc.plasma_plasma_collision(p, p, geom, pcfg, pcfg, pc, -1.0, 1e24,
                                      True, jax.random.PRNGKey(1), True)
    bo, po = jc.beam_plasma_collision(b, p, geom, bcfg, pcfg, pc, -1.0, 1e24,
                                      True, jax.random.PRNGKey(2), 1.0)
    valid = np.asarray(p["valid"])
    bad = int((~np.isfinite(np.asarray(q["ux"]))[valid]).sum())
    kick_uz = float(np.abs(np.asarray(bo["uz"]) - np.asarray(b["uz"])).max())
    kick_ux = float(np.abs(np.asarray(bo["ux"]) - np.asarray(b["ux"])).max())
    pk = np.abs(np.asarray(po["ux"]) - np.asarray(p["ux"]))
    print(f"{np.dtype(dtype).name} (x64 {'on' if x64 else 'off'}), {nxy}^2 "
          f"plasma lanes {n}, beam lanes {nb}: same-species non-finite ux "
          f"{bad} of {int(valid.sum())}; beam-plasma largest beam kicks uz "
          f"{kick_uz:.4e} ux {kick_ux:.4e}, largest plasma ux kick "
          f"{float(np.nanmax(pk)):.4e}, non-finite beam momenta "
          f"{int((~np.isfinite(np.asarray(bo['uz']))).sum())}", flush=True)
    if not x64:
        f32 = np.float32
        print(f"float32 of the guards and products: tiny 1e-300 -> "
              f"{f32(1e-300)!r}; n1 n2 = (1e24)^2 -> {f32(1e24) * f32(1e24)!r}"
              f"; q_e^4 -> {f32(cst.SI_q_e ** 4)!r}; m_e^2 -> "
              f"{f32(cst.SI_m_e) * f32(cst.SI_m_e)!r}; |p|^2 / c^2 of a "
              f"uz = 2000 electron -> "
              f"{f32(2000 * cst.SI_c * cst.SI_m_e) ** 2 / f32(cst.SI_c) ** 2!r}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nxy", type=int, default=64)
    ap.add_argument("--x64", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    run(args.nxy, args.x64)
    if not args.x64:
        env = dict(os.environ, JAX_ENABLE_X64="1")
        return subprocess.run([sys.executable, __file__, "--nxy",
                               str(args.nxy), "--x64"], env=env,
                              check=False).returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
