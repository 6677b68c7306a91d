"""The JAX package's per-slice uniforms, rebuilt for the port.

The JAX package draws a slice's field ionization and collisions from
``jax.random`` keys: the step's key is split once for the sweep's
``carry["key"]`` (``hipace_tpu/pipeline/simulation.py``), and on each slice
one subkey per ionization pair, then one per collision
(``hipace_tpu/pipeline/step.py``), each used as
``ionization_module`` and ``particles/collisions.py`` use theirs. The port
takes its uniforms as tensors from ``SliceStep.draws``; ``JaxSliceDraws``
is a substitute provider that hands it the JAX package's own draws in the
port's order, so a step of each package runs on the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def ionization_draw(key, n: int) -> np.ndarray:
    """ionization_module's uniforms (before its pid gather)."""
    return np.asarray(jax.random.uniform(key, (n,), jnp.float64))


def same_species_draws(key, n: int) -> dict:
    """plasma_plasma_collision's uniforms for one species of n lanes."""
    k_sort, k_kick = jax.random.split(key)
    keys = jax.random.split(k_kick, 4)

    def kick(fold):
        return np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, fold), (n,))) for k in keys])

    return {"sort": np.asarray(jax.random.uniform(k_sort, (n,))),
            "kick": kick(0), "wrap kick": kick(1)}


def inter_species_draws(key, n1: int, n2: int, lanes=None) -> dict:
    """_inter_species_collision's uniforms for n1 species-1 and n2
    species-2 lanes; lanes, where given, picks the species-1 lanes the port
    holds (its compacted emitted beam lanes)."""
    k1, k2, k3 = jax.random.split(key, 3)
    pick = np.asarray(jax.random.uniform(k2, (n1,)))
    kick = np.stack([np.asarray(jax.random.uniform(k, (n1,)))
                     for k in jax.random.split(k3, 4)])
    if lanes is not None:
        pick, kick = pick[lanes], kick[:, lanes]
    return {"sort": np.asarray(jax.random.uniform(k1, (n2,))),
            "pick": pick, "kick": kick}


def as_torch(draws: dict) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in draws.items()}


def step_carry_key(jsim):
    """The sweep's first carry["key"] of the JAX simulation's next
    run_step: run_step splits sim.key, the step splits its key again."""
    _, step_key = jax.random.split(jsim.key)
    return jax.random.split(step_key)[1]


class JaxSliceDraws:
    """A provider for the port's SliceStep.draws: the JAX simulation jsim's
    next step's uniforms, slice by slice from the head, in the port's order
    (each ionization pair's, then each collision's). A beam-plasma
    collision's species-1 draws are the JAX package's at its emitted lanes,
    the slip buffer's capacity first, then the slice's binned lanes; a step
    whose beam slips a lane is not supported (the port's lane count is
    checked against the slice's live lanes). Call `done()` to check that
    every draw was taken."""

    def __init__(self, jsim):
        from hipace_tpu.particles.plasma import plasma_count
        cfg = jsim.cfg
        pads = cfg.plasma_pad or (0,) * len(jsim.plasma_cfgs)
        # the lane counts, the binned beam and the key of the step jsim
        # runs next, taken now
        counts = [plasma_count(p, jsim.geom, jsim.dtype, cfg.normalized_units)
                  + pad for p, pad in zip(jsim.plasma_cfgs, pads)]
        self._seq = self._sequence(cfg, counts,
                                   np.array(jsim.binned["valid"]),
                                   step_carry_key(jsim))
        self.names = []

    @staticmethod
    def _sequence(cfg, counts, valid, key):
        n_beam = cfg.slip_cap + valid.shape[1]
        for islice in range(cfg.geom.nz - 1, -1, -1):
            for ip, *_ in cfg.ionization_pairs:
                key, sub = jax.random.split(key)
                yield "ionization", ionization_draw(sub, counts[ip])
            for kind, i1, i2, same, _ in cfg.collisions:
                key, sub = jax.random.split(key)
                if kind == "pp" and same:
                    d = same_species_draws(sub, counts[i1])
                    yield from (("sort", d["sort"]), ("kick", d["kick"]),
                                ("wrap kick", d["wrap kick"]))
                    continue
                if kind == "pp":
                    d = inter_species_draws(sub, counts[i1], counts[i2])
                else:
                    lanes = cfg.slip_cap + np.flatnonzero(valid[islice])
                    d = inter_species_draws(sub, n_beam, counts[i2], lanes)
                yield from (("sort", d["sort"]), ("pick", d["pick"]),
                            ("kick", d["kick"]))

    def __call__(self, name: str, *shape: int) -> torch.Tensor:
        want, arr = next(self._seq)
        assert (name, shape) == (want, arr.shape), (name, shape, want,
                                                    arr.shape)
        self.names.append(name)
        return torch.from_numpy(np.array(arr))

    def done(self) -> bool:
        return next(self._seq, None) is None
