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
  on its tensor's card, whichever card is current). The slice steps are bound by the host (its
  Python and launches), so on several cards the stages run one after
  another at about the serial loop's rate: a window of n steps costs about
  n serial steps on any number of cards. One host thread per card was
  slower still, as the threads queue for the interpreter lock at every
  launch (PERF.md, the pipeline's findings). Cards that overlap need a process per card, or a
  slice step whose launches do not bind the host.

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


def bin_blocks_into(entries, geom, tail: bool = False) -> None:
    """Bin each (rows, block) of entries: the block's valid lanes into the
    receive rows `rows` (nz lists of blocks, each a dict of 1-D tensors
    keyed by bm.ALL_ATTRS) by their slice, floor((z - lo_z) / dz), lanes
    outside the domain dropped as bm.bin_beam drops them. A sweep's block
    goes before what its rows hold (the sweep emits from the head), the
    slip carries (tail=True) after. Reads the lanes per slice of every
    block once, one read per receiving device."""
    nz = geom.nz
    work = []
    for rows, block in entries:
        if block["x"].numel() == 0:
            continue
        isl = bm.slice_index(block["z"], geom)
        ok = block["valid"] & (isl >= 0) & (isl < nz)
        key, order = torch.sort(torch.where(ok, isl, nz), stable=True)
        # lanes per slice, without the read that bincount makes on a card
        starts = torch.searchsorted(key, torch.arange(nz + 1,
                                                      device=key.device))
        work.append((rows, {k: v[order] for k, v in block.items()},
                     starts.diff()))
    if not work:
        return
    for (rows, block, _), counts in zip(work, _read_ints(
            [c for *_, c in work])):
        start = 0
        for i, c in enumerate(counts):
            if c:
                part = {k: v[start:start + c] for k, v in block.items()}
                if tail:
                    rows[i].append(part)
                else:
                    rows[i].insert(0, part)
                start += c


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
    draws = sim.plasma_draws()
    if cfg.ionization_pairs or cfg.collisions:
        gen = sim.generator
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        for d, ss in enumerate(steps):
            ss.draws.generator.manual_seed(seed + d)
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
    stream0 = None
    if cfg.use_laser:
        zc = torch.zeros_like(states[0]["laser_out"][0])
        stream0 = (tuple(a.to(devices[0]) for a in laser_stream)
                   if laser_stream is not None else (zc, zc))

    for t in range(nz + 2 * (n - 1)):
        sent = []
        for d in range(n):
            rel = t - 2 * d
            if not 0 <= rel < nz:
                continue
            i = nz - 1 - rel
            lrows = None
            if d == 0:
                this = {k: v[i] for k, v in binned0.items()}
                nxt = ({k: v[i - 1] for k, v in binned0.items()} if i
                       else dead[0])
                if stream0 is not None:
                    lrows = (stream0[0][i], stream0[1][i])
            else:
                this = assemble_row(rows[d][i], dead[d])
                nxt = assemble_row(rows[d][i - 1], dead[d]) if i else dead[d]
                if cfg.use_laser:
                    up = states[d - 1]["laser_out"]
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
