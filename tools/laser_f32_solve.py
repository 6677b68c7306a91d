"""Why LASER_WAKE's float32 Bx/By multigrid solve runs to max_iters on some
slices: the JAX package's step 0 on the CPU (XLA multigrid), in float32 and
float64.

For each Bx/By solve of the float32 step it prints the V-cycles, hpmg's
stopping target (tol_rel times the larger of the first residual and the rhs,
in max-norm), the last residual, and the rounding floor of a float32
residual evaluation, eps32 * |diag| * max|u| (the residual cancels terms of
the size of the diagonal times u, five rounded terms per cell, so it stalls
at a small multiple of that floor). Where the target lies within that
multiple, the solve cannot meet it and runs to max_iters. Then, per field of the
step's lev0 stack, the float32 step against the float64 one: the relative
difference of sum|f| (the checksum tests/test_f32_physics.py holds) and
max|f32 - f64| / max|f64|.

    JAX_PLATFORMS=cpu python tools/laser_f32_solve.py --nxy 511 --nz 64

511^2 x 64 takes about 4 minutes and 6 GiB on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from hipace_tpu.fields import multigrid as jmg  # noqa: E402
from hipace_tpu.parser import Inputs  # noqa: E402
from hipace_tpu.pipeline.simulation import Simulation  # noqa: E402
from hipace_tpu_torch.decks import LASER_WAKE  # noqa: E402
from hipace_tpu_torch.pipeline.step import DIAG_COMPS  # noqa: E402


def recording_solve(rows):
    """The XLA branch of MultiGrid.solve; per real solve (cycles, target,
    last residual, max|u|, |diag|) sent to the host."""
    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2, fused=None):
        acfs = self._coarsen_acf(acf)
        res0 = jnp.max(jnp.abs(rhs - self.apply_op(u0, acfs[0], 0)))
        target = jnp.maximum(tol_abs, jnp.maximum(tol_rel, 1e-16)
                             * jnp.maximum(res0, jnp.max(jnp.abs(rhs))))

        def body(c):
            u, _, it = c
            u = self._vcycle(u, rhs, acfs, 0, nu1, nu2)
            return (u, jnp.max(jnp.abs(rhs - self.apply_op(u, acfs[0], 0))),
                    it + 1)

        u, res, it = jax.lax.while_loop(
            lambda c: (c[1] > target) & (c[2] < max_iters), body,
            (u0, res0, jnp.zeros((), jnp.int32)))
        if not jnp.iscomplexobj(u0):
            facx, facy = self.facs[0]
            jax.debug.callback(
                lambda *v: rows.append(tuple(float(x) for x in v)), it,
                target, res, jnp.max(jnp.abs(u)), 2.0 * (facx + facy),
                ordered=True)
        return u
    return solve


def run(nxy, nz, dtype, rows):
    deck = (LASER_WAKE.format(nxy=nxy, nz=nz, npart=0)
            + "max_step = 0\nhipace.use_banded = 0\n")
    sim = Simulation(Inputs(deck), dtype=dtype, verbose=0)
    out = np.asarray(sim.run_step(0)["diag"]).astype(np.float64)
    jax.effects_barrier()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nxy", type=int, default=511)
    ap.add_argument("--nz", type=int, default=64)
    args = ap.parse_args()
    rows32, rows64 = [], []
    jmg.MultiGrid.solve = recording_solve(rows32)
    d32 = run(args.nxy, args.nz, jnp.float32, rows32)
    jmg.MultiGrid.solve = recording_solve(rows64)
    d64 = run(args.nxy, args.nz, jnp.float64, rows64)
    eps = float(np.finfo(np.float32).eps)
    print(f"LASER_WAKE {args.nxy}^2 x {args.nz}, step 0, JAX package on the "
          f"CPU (XLA multigrid)")
    print("float64 Bx/By V-cycles per slice, head first:",
          [int(r[0]) for r in rows64])
    print("float32 Bx/By V-cycles per slice, head first:",
          [int(r[0]) for r in rows32])
    ratios = [t / (eps * d * u) for c, t, _, u, d in rows32 if c < 40]
    print(f"float32 solves that converged: target / floor down to "
          f"{min(ratios):.2f}; the solves at max_iters:")
    for i, (cyc, target, res, umax, diag) in enumerate(rows32):
        floor = eps * diag * umax
        if cyc >= 40:
            print(f"  slice {i}: {int(cyc)} V-cycles, target {target:.3e}, "
                  f"last residual {res:.3e}, floor {floor:.3e} "
                  f"(target / floor {target / floor:.2f}, residual / floor "
                  f"{res / floor:.2f})")
    comps = list(DIAG_COMPS) + ["aabs"]
    print("per field, float32 against float64: checksum sum|f| rel, "
          "max|d| / max|f64|")
    for i in range(d64.shape[1]):
        s32, s64 = np.abs(d32[:, i]).sum(), np.abs(d64[:, i]).sum()
        top = np.abs(d64[:, i]).max()
        pt = np.abs(d32[:, i] - d64[:, i]).max() / top if top else 0.0
        cs = abs(s32 - s64) / s64 if s64 else 0.0
        print(f"  {comps[i]:8s} sum|f64| {s64:.6e}  checksum {cs:.3e}  "
              f"pointwise {pt:.3e}")


if __name__ == "__main__":
    main()
