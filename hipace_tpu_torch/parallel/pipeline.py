"""Longitudinal pipeline parallelism: a window of n consecutive time steps,
stage d running step base + d.

Port of ``hipace_tpu/parallel/pipeline.py`` (ref MultiBuffer.{H,cpp},
Hipace.cpp:400-401: rank r computes time steps r, r + N, ... and streams its
pushed beam slices head to tail to rank r + 1). The JAX package runs the
stages as one shard_map program over a device mesh, in a lockstep "skewed
tick loop" with a ppermute between neighbours. Here one process drives a
list of devices, one stage per entry, and runs the same schedule in Python.
An entry may repeat: several stages may share one card, or the CPU.

- The window takes nz + 2 (n - 1) ticks. At tick t stage d is active when
  0 <= t - 2d < nz, on slice nz - 1 - (t - 2d): two slices behind its
  upstream, since its slice i needs upstream's lanes emitted from slice
  i - 1 (the reference's get_data(islice - 1)). An inactive stage is not
  called.
- Stage 0 reads the window's beam, stage d > 0 its receive rows (this
  slice's and the next one's). The lanes an active stage emits go to the
  next stage, ``tensor.to(devices[(d + 1) % n])``, which bins them into its
  receive rows by their new zeta (``bin_blocks_into``, one read of each
  receiving device per tick). After the last tick each stage's slip carry
  goes round the ring once. Stage n - 1's lanes wrap to stage 0's rows: the
  beam after the window.
- A laser: stage d reads upstream's (np1, n00) rows of slice i, written two
  ticks before, as its (n00, nm1); stage 0 reads the window's stream, and
  stage n - 1's is the next window's.
- One host thread drives every stage in turn (each kernel wrapper launches
  on its tensor's card, whichever card is current). The slice steps are
  bound by the host (its Python and launches), so here the stages run one
  after another, also on several cards: a window of n steps costs about n
  serial steps. ``parallel/ranks.py`` runs the same schedule with one
  process per stage (``Simulation.evolve_ranks``), so that the stages of a
  window run at the same time; this module is its CPU oracle and shares
  its schedule (``n_ticks``, ``stage_slice``), rows (``stage_lanes``,
  ``sort_block``, ``insert_block``) and seeds (``seed_stages``) with it.

The receive rows grow with what arrives. The JAX package gives them a fixed
capacity, beam_cap + slip_cap, drops the lanes beyond it without a word and
re-runs the window with a larger slip_cap; here no lane is dropped and
nothing re-runs. A row keeps its lanes in the order in which a serial
step's re-binning leaves them (by the slice that emitted them, from the
tail; the slip carry last) and is padded with dead lanes to the serial row
width, so a stage computes what a serial step computes from the same lanes.

Each stage has its own SliceStep (``Simulation.stage_slice_steps``) and its
own fresh plasma, background, carry and output buffers
(``Simulation.step_state``). Ionization and collisions draw from the
stage's generator, seeded from the simulation's generator once per window
(the JAX package's ``fold_in(key, d)``). Every stage of a window takes the
same plasma temperature draws, as every stage of a JAX window initializes
its plasma from the window's one key (ROADMAP R22).
"""

from __future__ import annotations

import torch

from ..particles import beam as bm


def _read_ints(tensors: list) -> list:
    """The values of 1-D integer device tensors as lists, one read per
    device."""
    out = [None] * len(tensors)
    by_dev: dict = {}
    for j, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(j)
    for js in by_dev.values():
        for j, vals in zip(js, torch.stack([tensors[j] for j in js])
                           .tolist()):
            out[j] = vals
    return out


def sort_block(block: dict, geom) -> tuple:
    """A block's lanes sorted by their slice, floor((z - lo_z) / dz), and
    the lanes per slice: nz + 1 counts on the block's device, the last the
    lanes that bm.bin_beam would drop (dead or outside the domain), which
    the sort puts at the end. No read of the device."""
    nz = geom.nz
    isl = bm.slice_index(block["z"], geom)
    ok = block["valid"] & (isl >= 0) & (isl < nz)
    key, order = torch.sort(torch.where(ok, isl, nz), stable=True)
    # lanes per slice, without the read that bincount makes on a card
    starts = torch.searchsorted(key, torch.arange(nz + 2, device=key.device))
    return {k: v[order] for k, v in block.items()}, starts.diff()


def insert_block(rows: list, block: dict, counts, tail: bool = False) -> None:
    """Put a sorted block (sort_block's, with its counts as ints) into the
    receive rows `rows` (nz lists of blocks, each a dict of 1-D tensors
    keyed by bm.ALL_ATTRS): a sweep's block before what a row holds (the
    sweep emits from the head), the slip carries (tail=True) after."""
    start = 0
    for i, c in enumerate(counts[:len(rows)]):
        if c:
            part = {k: v[start:start + c] for k, v in block.items()}
            if tail:
                rows[i].append(part)
            else:
                rows[i].insert(0, part)
            start += c


def bin_blocks_into(entries, geom, tail: bool = False) -> None:
    """Bin each (rows, block) of entries: the block's valid lanes into the
    receive rows `rows` by their slice (sort_block, insert_block), lanes
    outside the domain dropped as bm.bin_beam drops them. Reads the lanes
    per slice of every block once, one read per receiving device."""
    work = [(rows,) + sort_block(block, geom) for rows, block in entries
            if block["x"].numel()]
    for (rows, block, _), counts in zip(work, _read_ints(
            [c for *_, c in work])):
        insert_block(rows, block, counts, tail)


def seed_stages(sim, steps: list, first: int = 0) -> list:
    """A window's draws from the simulation's generator, in the order every
    stage and rank takes them: each species' plasma temperature draws
    (plasma_draws, one set for every stage, ROADMAP R22), then with
    ionization or collisions one seed, stage d's generator seeded seed + d
    (the JAX package's fold_in(key, d)); steps are the SliceSteps of the
    stages first, first + 1, .... Returns the plasma draws."""
    draws = sim.plasma_draws()
    if sim.cfg.ionization_pairs or sim.cfg.collisions:
        gen = sim.generator
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        for j, ss in enumerate(steps):
            ss.draws.generator.manual_seed(seed + first + j)
    return draws


def assemble_row(blocks: list, dead: dict) -> dict:
    """A receive row as one slice's lanes: its blocks' lanes in order, then
    dead lanes up to the width of `dead`, the serial row's."""
    if not blocks:
        return dead
    n = sum(b["x"].numel() for b in blocks)
    pad = max(dead["x"].numel() - n, 0)
    return {k: torch.cat([b[k] for b in blocks] + [v[:pad]])
            for k, v in dead.items()}


def rows_flat(rows: list, dead: dict) -> dict:
    """Every lane of the receive rows, slice by slice, as flat tensors."""
    blocks = [b for row in rows for b in row]
    return {k: torch.cat([b[k] for b in blocks] + [v[:0]])
            for k, v in dead.items()}


def n_ticks(nz: int, n: int) -> int:
    """The ticks of a window of n stages over nz slices."""
    return nz + 2 * (n - 1)


def stage_slice(t: int, d: int, nz: int):
    """The slice stage d sweeps at tick t of a window, None where it is
    inactive: two slices behind its upstream, whose lanes emitted from
    slices >= i - 1 its slice i needs."""
    rel = t - 2 * d
    return nz - 1 - rel if 0 <= rel < nz else None


def stage_lanes(i: int, binned0, rows: list, dead: dict) -> tuple:
    """A stage's (this, nxt) lanes for slice i: stage 0's from the window's
    binned beam binned0, a later stage's (binned0 None) from its receive
    rows, each padded to the serial row width."""
    if binned0 is not None:
        return ({k: v[i] for k, v in binned0.items()},
                {k: v[i - 1] for k, v in binned0.items()} if i else dead)
    return (assemble_row(rows[i], dead),
            assemble_row(rows[i - 1], dead) if i else dead)


def first_stream(st: dict, laser_stream, device) -> tuple:
    """Stage 0's laser stream (n00, nm1) on its device: the window's, zeros
    where None (before the first step)."""
    if laser_stream is None:
        zc = torch.zeros_like(st["laser_out"][0])
        return zc, zc
    return tuple(a.to(device) for a in laser_stream)


def pipelined_window(sim, binned: dict, dts, times, base_step: int, devices,
                     laser_stream=None) -> dict:
    """Run the n = len(devices) time steps base_step .. base_step + n - 1 of
    the Simulation `sim`, step base_step + d on stage d at dts[d] and
    times[d], from the binned beam `binned` and, with a laser, the stream
    (n00, nm1) (zeros where None).

    Returns {"stages": each stage's step result (as sim._time_step's, but
    for binned), "inputs": each step's beam before its push (binned for
    stage 0, stage d's receive rows as flat lanes for d > 0), "beam": the
    lanes after the window (stage 0's receive rows, flat), and with a laser
    "laser_stream": the stream after the window}."""
    n, g, cfg = len(devices), sim.geom, sim.cfg
    nz = g.nz
    steps = sim.stage_slice_steps(devices)
    draws = seed_stages(sim, steps)
    binned0 = {k: binned[k].to(devices[0]) for k in bm.ALL_ATTRS}
    states = [sim.step_state(
        times[d], dts[d], base_step + d, steps[d], devices[d],
        binned=binned0 if d == 0 else None,
        draws=[None if x is None else x.to(devices[d]) for x in draws])
        for d in range(n)]
    # the dead lanes that pad a row to the serial width, per stage
    dead = [{k: torch.zeros_like(v[0], device=dev)
             for k, v in binned0.items()} for dev in devices]
    rows = [[[] for _ in range(nz)] for _ in range(n)]
    if cfg.use_laser:
        stream0 = first_stream(states[0], laser_stream, devices[0])

    for t in range(n_ticks(nz, n)):
        sent = []
        for d in range(n):
            i = stage_slice(t, d, nz)
            if i is None:
                continue
            this, nxt = stage_lanes(i, binned0 if d == 0 else None, rows[d],
                                    dead[d])
            lrows = None
            if cfg.use_laser:
                up = stream0 if d == 0 else states[d - 1]["laser_out"]
                lrows = (up[0][i].to(devices[d]), up[1][i].to(devices[d]))
            emit = sim.sweep_slice(states[d], i, this, nxt, lrows)
            nd = (d + 1) % n
            sent.append((rows[nd], {k: v.to(devices[nd])
                                    for k, v in emit.items()}))
        bin_blocks_into(sent, g)
    # the slip carries go round the ring once
    bin_blocks_into([(rows[(d + 1) % n],
                      {k: v.to(devices[(d + 1) % n])
                       for k, v in st["carry"]["slip"].items()})
                     for d, st in enumerate(states)], g, tail=True)

    sim.read_step_counts(*states)
    out = {"stages": [sim.step_result(st) for st in states],
           "inputs": [binned] + [rows_flat(rows[d], dead[d])
                                 for d in range(1, n)],
           "beam": rows_flat(rows[0], dead[0])}
    if cfg.use_laser:
        out["laser_stream"] = states[-1]["laser_out"]
    return out
