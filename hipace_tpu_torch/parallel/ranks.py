"""The pipeline as one process per stage: ranks on a ring of
``torch.distributed`` point-to-point messages.

The reference runs a pipelined time loop as MPI ranks on a ring (ref
MultiBuffer.{H,cpp}, Hipace.cpp:400-401): rank r computes time steps r,
r + N, ... and streams its pushed beam slices to rank r + 1. The JAX package
runs the same schedule as one shard_map program over a mesh, and
``pipeline.pipelined_window`` as one host thread over a device list. Here
each stage is a process on its own device, so that the stages of a window
run at the same time:

- ``Ring``: rank r of n sends to r + 1 and receives from r - 1 (ref
  MultiBuffer.cpp:66-67). Ranks on distinct cards talk over NCCL
  (``batch_isend_irecv``, each tick's send and receive in one batch); ranks
  that share a card, or run on the CPU, over gloo, a card's tensors staged
  through pinned host memory. The backend follows from the device list
  before the process group starts; nothing falls back to another backend.
- ``rank_window``: rank d's part of ``pipelined_window``, with its tick
  schedule (``stage_slice``), receive rows (``stage_lanes``,
  ``insert_block``) and generator seeds (``seed_stages``). At every tick an
  active rank sends the lanes it emitted, sorted by slice with the lanes per
  slice in a header (``sort_block``: the receiver bins without a read of
  its device), and with a laser its (np1, n00) rows of the slice; after the
  last tick every rank sends its slip carry. On the CPU a rank computes what
  its stage of ``pipelined_window`` computes, bit for bit.
- ``spawn``: n processes, each ``python -m hipace_tpu_torch.parallel.ranks``
  (so a rank imports the port and nothing of the program that spawned it),
  meeting through a ``FileStore`` in a temporary directory, each running
  ``run_job`` (a Simulation of a deck, ``evolve_ranks``) and returning its
  result through a file. A rank that fails makes ``spawn`` raise with its
  traceback; a run that outlasts its timeout is killed. The CLI starts one
  rank per card this way (``python -m hipace_tpu_torch`` with more than one
  GPU), or joins the group that ``torchrun`` made.

Every rank builds its own Simulation from the same deck and takes the same
draws from its generator (the beam, each window's plasma draws and seed),
so every rank's generator advances as every other's.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..particles import beam as bm
from ..tracing import OFF, span, traced
from . import pipeline as pp

# a message or collective that waits longer than this raises on its rank
COMM_TIMEOUT = datetime.timedelta(minutes=10)


def choose_backend(devices) -> tuple:
    """(backend, why) for ranks on `devices`, one per rank: NCCL where every
    rank has a card of its own, gloo where ranks share a card or run on
    the CPU. Raises on a list that mixes the CPU and cards."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo", f"{n} ranks on the CPU: gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {[str(d) for d in devices]}: all on "
                         "the CPU or all on cards")
    idx = [0 if d.index is None else d.index for d in devices]
    for i in idx:
        if idx.count(i) > 1:
            return "gloo", f"{idx.count(i)} ranks share cuda:{i}: gloo"
    return "nccl", f"{n} ranks on {n} cards: nccl"


def _layout(dead: dict) -> list:
    """The lanes' (attribute, dtype) in a message body, the widest dtype
    first, so that every attribute starts aligned to its itemsize."""
    return sorted(((k, v.dtype) for k, v in dead.items()),
                  key=lambda kv: -kv[1].itemsize)


def _pack(block: dict, layout: list):
    """A block's lanes as one byte tensor, attribute after attribute."""
    return torch.cat([block[k].reshape(-1).view(torch.uint8)
                      for k, _ in layout])


def _unpack(buf, layout: list, m: int) -> dict:
    """_pack's m lanes back as views of buf."""
    out, off = {}, 0
    for k, dtype in layout:
        size = m * dtype.itemsize
        out[k] = buf[off:off + size].view(dtype)
        off += size
    return out


class Ring:
    """Rank `rank` of `size` processes on a ring: sends go to rank + 1,
    receives come from rank - 1 (ref MultiBuffer.cpp:66-67). `device` is
    the rank's; `backend` "nccl" (tensors on the card) or "gloo" (tensors
    on the host, a card's staged through pinned memory)."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank, self.size = rank, size
        self.device, self.backend = torch.device(device), backend
        self.send_to = (rank + 1) % size
        self.recv_from = (rank - 1) % size
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.comm_device = (self.device if backend == "nccl"
                            else torch.device("cpu"))

    @classmethod
    def start(cls, rank: int, devices, store=None) -> Ring:
        """Join the process group of len(devices) ranks as `rank` on
        devices[rank] (through `store`, else the environment's
        MASTER_ADDR/MASTER_PORT), over choose_backend's backend."""
        devices = [torch.device(d) for d in devices]
        backend, why = choose_backend(devices)
        return cls._join(rank, len(devices), devices[rank], backend, why,
                         store)

    @classmethod
    def from_env(cls, device=None) -> Ring:
        """Join the group that torchrun describes (RANK, WORLD_SIZE,
        LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT): rank r on
        cuda:LOCAL_RANK, over NCCL where each rank of a host has a card of
        its own, else over gloo; on the CPU where device is "cpu"."""
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device is not None and torch.device(device).type == "cpu":
            return cls.start(rank, ["cpu"] * size)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank)) % max(cards, 1)
        backend, why = (
            ("nccl", f"{size} ranks under torchrun, one card each: nccl")
            if per_host <= cards else
            ("gloo", f"{per_host} ranks on a host of {cards} cards: gloo"))
        return cls._join(rank, size, torch.device("cuda", local), backend,
                         why, None)

    @classmethod
    def _join(cls, rank, size, device, backend, why, store) -> Ring:
        """Initialize the process group, start every pair of neighbours
        with one exchange; rank 0 prints the backend and why."""
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        kw = {"store": store} if store is not None else {}
        dist.init_process_group(backend, rank=rank, world_size=size,
                                timeout=COMM_TIMEOUT, **kw)
        ring = cls(rank, size, device, backend)
        # the first message between two ranks sets up their communicator:
        # every rank takes part in this one, before any timed work
        one = torch.zeros(1, dtype=torch.uint8, device=ring.comm_device)
        ring._swap(one, 1)
        ring.barrier()
        if rank == 0:
            print(f"ranks: {why}", flush=True)
        return ring

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def _swap(self, out, n_in):
        """Send the byte tensor `out` (None: nothing) to the next rank and
        receive n_in bytes (None: nothing) from the previous one, both at
        once; the bytes received, on the card over NCCL, else on the host
        (pinned where the rank has a card)."""
        if self.backend == "nccl":
            got = (torch.empty(n_in, dtype=torch.uint8, device=self.device)
                   if n_in is not None else None)
            ops = []
            if out is not None:
                ops.append(dist.P2POp(dist.isend, out, self.send_to))
            if got is not None:
                ops.append(dist.P2POp(dist.irecv, got, self.recv_from))
            if ops:
                # waiting orders the card's stream after the transfers, so
                # the send buffer outlives its transfer
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return got
        if out is not None and self.staged:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out)
            out = host
        got = (torch.empty(n_in, dtype=torch.uint8, pin_memory=self.staged)
               if n_in is not None else None)
        works = []
        if out is not None:
            works.append(dist.isend(out, self.send_to))
        if got is not None:
            works.append(dist.irecv(got, self.recv_from))
        for work in works:
            work.wait()
        return got

    @traced("ring exchange")
    def exchange(self, out, recv: bool, geom, layout: list, laser=None):
        """One message round the ring. out: None, or (block, laser rows or
        None), the lanes this rank emitted (a dict keyed as `layout`) and
        its (np1, n00) rows of the slice, for the next rank. With recv, the
        previous rank's message comes back as (block sorted by slice, lanes
        per slice as ints (sort_block's nz + 1), laser rows or None), on
        this rank's device. laser: (row shape, complex dtype) where the
        messages carry laser rows. Two transfers: a header of fixed size
        (the laser rows, the lane counts), then the lanes."""
        head_bytes = 8 * (geom.nz + 1)
        row_bytes = 0
        if laser is not None:
            row_bytes = math.prod(laser[0]) * laser[1].itemsize
        head = body = None
        if out is not None:
            block, lrows = out
            block, counts = pp.sort_block(block, geom)
            # the laser rows first: the counts' offset stays a multiple of
            # 8, and the rows' (in reals) even, as view_as_complex needs
            parts = [counts.view(torch.uint8)]
            if laser is not None:
                parts.insert(0, torch.view_as_real(torch.stack(lrows))
                             .reshape(-1).view(torch.uint8))
            head = torch.cat(parts)
            if block["x"].numel():
                body = _pack(block, layout)
        with span("ring wait"):
            got = self._swap(head, head_bytes + 2 * row_bytes if recv
                             else None)
        # over NCCL the header is on the card
        with span("read: ring counts") if recv else OFF:
            counts = (got[2 * row_bytes:].view(torch.int64).tolist()
                      if recv else [])
        m = sum(counts)
        lane_bytes = sum(dtype.itemsize for _, dtype in layout)
        with span("ring wait"):
            got_body = self._swap(body, m * lane_bytes if m else None)
        if not recv:
            return None
        block = (_unpack(got_body.to(self.device, non_blocking=True),
                         layout, m) if m else
                 {k: torch.zeros(0, dtype=dtype, device=self.device)
                  for k, dtype in layout})
        rows = None
        if laser is not None:
            real = torch.view_as_real(torch.zeros(0, dtype=laser[1])).dtype
            rows = torch.view_as_complex(
                got[:2 * row_bytes].view(real).reshape(2, *laser[0], 2)
                .to(self.device, non_blocking=True))
            rows = (rows[0], rows[1])
        return block, counts, rows

    def gather_objects(self, obj):
        """Every rank's obj on rank 0 (a list in rank order), None on the
        others."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def broadcast_floats(self, values, k: int, src: int) -> list:
        """Rank src's k floats (`values` there, ignored elsewhere) on every
        rank."""
        t = torch.tensor(values if self.rank == src else [0.0] * k,
                         dtype=torch.float64, device=self.comm_device)
        dist.broadcast(t, src)
        return t.tolist()


def rank_window(sim, ring: Ring, binned: dict, dts, times, base_step: int,
                laser_stream=None) -> dict:
    """Rank d = ring.rank's part of the window of n = ring.size time steps
    base_step .. base_step + n - 1 (pipeline.pipelined_window's stage d):
    step base_step + d at dts[d] and times[d], on the rank's device, from
    the binned beam `binned` (read on rank 0 only; elsewhere its row width
    pads the receive rows) and, on rank 0 with a laser, the stream (n00,
    nm1) (zeros where None).

    Returns {"stage": the step's result (as pipelined_window's stages),
    "input": the step's beam before its push (binned on rank 0, the
    receive rows as flat lanes elsewhere)}, on rank 0 also "beam", the
    lanes after the window (rank n - 1's, flat), and with a laser
    "laser_stream", the stream after the window (rank n - 1's rows)."""
    with span("time step", step=base_step + ring.rank, device=ring.device):
        return _rank_window(sim, ring, binned, dts, times, base_step,
                            laser_stream)


def _rank_window(sim, ring: Ring, binned: dict, dts, times, base_step: int,
                 laser_stream=None) -> dict:
    n, d, dev = ring.size, ring.rank, ring.device
    g, cfg = sim.geom, sim.cfg
    nz = g.nz
    steps = sim.stage_slice_steps([dev])
    draws = pp.seed_stages(sim, steps, first=d)
    binned0 = ({k: binned[k].to(dev) for k in bm.ALL_ATTRS} if d == 0
               else None)
    st = sim.step_state(times[d], dts[d], base_step + d, steps[0], dev,
                        binned=binned0, draws=draws)
    # the dead lanes that pad a row to the serial width
    dead = {k: torch.zeros_like(binned[k][0], device=dev)
            for k in bm.ALL_ATTRS}
    layout = _layout(dead)
    rows = [[] for _ in range(nz)]
    laser = None
    if cfg.use_laser:
        laser = (tuple(st["laser_out"][0].shape[1:]),
                 st["laser_out"][0].dtype)
        # rank 0 reads the window's stream and collects the next one from
        # rank n - 1; a later rank reads upstream's rows of each slice
        if d == 0:
            stream = pp.first_stream(st, laser_stream, dev)
            after = tuple(torch.empty_like(a) for a in st["laser_out"])
        up_rows = {}
    up = (d - 1) % n
    for t in range(pp.n_ticks(nz, n)):
        i = pp.stage_slice(t, d, nz)
        out = None
        if i is not None:
            this, nxt = pp.stage_lanes(i, binned0, rows, dead)
            lrows = None
            if laser is not None:
                lrows = ((stream[0][i], stream[1][i]) if d == 0
                         else up_rows.pop(i))
            emit = sim.sweep_slice(st, i, this, nxt, lrows)
            out = (emit, None if laser is None else
                   (st["laser_out"][0][i], st["laser_out"][1][i]))
        j = pp.stage_slice(t, up, nz)
        got = ring.exchange(out, j is not None, g, layout, laser)
        if got is not None:
            block, counts, lrows = got
            pp.insert_block(rows, block, counts)
            if laser is not None:
                if d == 0:
                    after[0][j], after[1][j] = lrows
                else:
                    up_rows[j] = lrows
    # the slip carries go round the ring once
    block, counts, _ = ring.exchange((st["carry"]["slip"], None), True, g,
                                     layout)
    pp.insert_block(rows, block, counts, tail=True)

    sim.read_step_counts(st)
    res = {"stage": sim.step_result(st),
           "input": binned0 if d == 0 else pp.rows_flat(rows, dead)}
    if d == 0:
        res["beam"] = pp.rows_flat(rows, dead)
        if laser is not None:
            res["laser_stream"] = after
    return res


# ------------------------------------------------------------------ spawn
@dataclasses.dataclass
class Job:
    """What every rank of a run does: build a Simulation of `deck` (a deck's
    text, with `overrides`) on its device in `dtype` ("float32",
    "float64"; None: the device's), then run ``evolve_ranks`` once per
    entry of `max_steps` (None: the deck's max_step), each run from the
    simulation's initial state, in `workdir` (its output files; None: the
    current directory). With cli, rank 0 prints the CLI's closing lines;
    with keep_steps, each rank keeps, for every step it ran, the V-cycles
    per slice and whether the fields are finite. start: a file of
    torch.save({"binned": {attribute: (nz, cap) tensor}, "dt": dt}), the
    beam (and dt) every rank starts from instead of its own draw."""

    deck: str
    overrides: tuple = ()
    dtype: str | None = None
    max_steps: tuple = (None,)
    write_output: bool = True
    workdir: str | None = None
    verbose: int | None = None
    cli: bool = False
    keep_steps: bool = False
    start: str | None = None


def _kernels() -> dict:
    from ..ops.deposit import deposit
    from ..ops.gather import gather_main
    from ..ops.mg_kernel import mg_solve
    return {"K1": deposit, "K2": gather_main, "K3": mg_solve}


def _snapshot(sim) -> dict:
    return {"binned": {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in sim.binned.items()},
            "dt": sim.dt, "min_uz_mq": sim.min_uz_mq,
            "laser_stream": sim.laser_stream,
            "generator": sim.generator.get_state()}


def _restore(sim, snap: dict, max_step) -> None:
    sim.binned = {k: v.clone() if torch.is_tensor(v) else v
                  for k, v in snap["binned"].items()}
    sim.time, sim.dt, sim.min_uz_mq = 0.0, snap["dt"], snap["min_uz_mq"]
    sim.laser_stream = snap["laser_stream"]
    sim.generator.set_state(snap["generator"])
    sim._has_last_step = False
    if max_step is not None:
        sim.max_step = max_step


def generator_probe(sim) -> list:
    """16 float64 uniforms from a copy of the simulation's generator: equal
    where two simulations' generators would draw the same."""
    gen = torch.Generator(device=sim.device)
    gen.set_state(sim.generator.get_state())
    return torch.rand(16, generator=gen, device=sim.device,
                      dtype=torch.float64).tolist()


def _step_record(res: dict) -> dict:
    """A step's V-cycles per slice and whether its fields are finite (slice
    by slice: a flag of the whole stack would hold a copy of it)."""
    finite = torch.stack([torch.isfinite(d).all() for d in res["diag"]])
    return {"mg_cycles": list(res["mg_cycles"]),
            "finite": bool(finite.all())}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_job(ring: Ring, job: Job) -> dict:
    """One rank's part of a Job. Returns {"runs": per run its seconds (from
    a barrier to the rank's end: rank 0 ends last, with the beam after
    the last window and any serial tail), the rank's peak device memory in
    bytes (None on the CPU), its K1/K2/K3 launches and, with keep_steps,
    {step: _step_record}; "probe": generator_probe after the set-up;
    "lanes": the valid beam lanes at the start; "modules": the modules of
    jax or hipace_tpu the process has imported (none)}; on rank 0 also
    "final": the beam (binned, on the host), time, dt and laser stream
    after the last run."""
    from ..__main__ import _profiled
    from ..parser import Inputs
    from ..pipeline.simulation import Simulation
    from . import ranks
    cwd = os.getcwd()
    if job.workdir is not None:
        os.makedirs(job.workdir, exist_ok=True)
        os.chdir(job.workdir)
    try:
        t_start = time.perf_counter()
        dev = ring.device
        dtype = None if job.dtype is None else getattr(torch, job.dtype)
        # the input parameters are printed once, by rank 0
        quiet = ["hipace.output_input = 0"] if ring.rank else []
        sim = Simulation(Inputs(job.deck, list(job.overrides) + quiet),
                         device=dev, dtype=dtype, verbose=job.verbose)
        trace_dir = (sim.inputs.query("hipace.profile", "", str) if job.cli
                     else "")
        if job.start is not None:
            from ..convert import carry_state
            start = torch.load(job.start, weights_only=False)
            carry_state(sim, {k: v.cpu().numpy()
                              for k, v in start["binned"].items()},
                        start["dt"], 0.0)
        out = {"runs": [], "probe": generator_probe(sim),
               "lanes": int(sim.binned["valid"].sum()),
               "modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "hipace_tpu"))}
        snap = _snapshot(sim)
        kernels = _kernels()
        window = ranks.rank_window
        for max_step in job.max_steps:
            _restore(sim, snap, max_step)
            kept = {}
            if job.keep_steps:
                def keep_window(s, r, binned, dts, times, base, *a):
                    res = window(s, r, binned, dts, times, base, *a)
                    kept[base + r.rank] = _step_record(res["stage"])
                    return res

                def keep_serial(step, _run=sim.run_step):
                    res = _run(step)
                    kept[step] = _step_record(res)
                    return res
                ranks.rank_window = keep_window
                sim.run_step = keep_serial
            for fn in kernels.values():
                fn.launches = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            ring.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            try:
                with _profiled(trace_dir, dev):
                    sim.evolve_ranks(ring, write_output=job.write_output)
            finally:
                ranks.rank_window = window
                sim.__dict__.pop("run_step", None)
            _sync(dev)
            out["runs"].append({
                "seconds": time.perf_counter() - t0,
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
                "launches": {k: fn.launches for k, fn in kernels.items()},
                "steps": kept})
        if ring.rank == 0:
            out["final"] = {
                "binned": {k: v.cpu() if torch.is_tensor(v) else v
                           for k, v in sim.binned.items()},
                "time": sim.time, "dt": sim.dt,
                "laser_stream": (None if sim.laser_stream is None else
                                 tuple(a.cpu() for a in sim.laser_stream))}
            if job.cli:
                from ..__main__ import report
                report(sim, time.perf_counter() - t_start, ring.size)
        return out
    finally:
        os.chdir(cwd)


def _child(folder: str, rank: int) -> int:
    """A spawned rank (``python -m hipace_tpu_torch.parallel.ranks FOLDER
    RANK``): read spawn's spec in FOLDER, join the ring, run every job and
    save the results there; on an error its traceback goes to
    FOLDER/rank<RANK>.err."""
    folder = Path(folder)
    try:
        spec = torch.load(folder / "spec.pt", weights_only=False)
        torch.set_num_threads(spec["threads"])
        devices = spec["devices"]
        ring = Ring.start(rank, devices, dist.FileStore(
            str(folder / "store"), len(devices)))
        try:
            results = [run_job(ring, Job(**job)) for job in spec["jobs"]]
            torch.save(results, folder / f"rank{rank}.pt")
        finally:
            ring.close()
    except BaseException:
        (folder / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    return 0


def spawn(jobs, devices, timeout: float | None = 900.0, tmp=None,
          threads: int | None = None) -> list:
    """Run `jobs` (a Job, a deck's text, or a list of them, run one after
    another by the same processes) on one process per entry of `devices`
    (rank r on devices[r]; an entry may repeat), each started as ``python
    -m hipace_tpu_torch.parallel.ranks`` (it imports the port and nothing
    of its caller), meeting through a FileStore in a temporary directory
    under `tmp`. Returns, per job, each rank's run_job result (a list per
    job; a plain list where `jobs` was one job).

    A rank that fails makes spawn raise with its traceback, and the other
    ranks are killed; so are all of them where the run outlasts `timeout`
    seconds (None: no limit; a rank that waits on a dead peer still raises
    after COMM_TIMEOUT). threads: each rank's torch threads (default: the
    host's cores over the ranks)."""
    one = not isinstance(jobs, (list, tuple))
    jobs = [Job(j) if isinstance(j, str) else j
            for j in ([jobs] if one else jobs)]
    devices = [torch.device(d) for d in devices]
    choose_backend(devices)     # a bad device list raises before any rank
    n = len(devices)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(dir=tmp) as folder:
        folder = Path(folder)
        torch.save({"devices": [str(d) for d in devices], "threads": threads,
                    "jobs": [dataclasses.asdict(j) for j in jobs]},
                   folder / "spec.pt")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hipace_tpu_torch.parallel.ranks",
             str(folder), str(r)], env=env) for r in range(n)]
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    # the peers of a failed rank fail on it in turn: a few
                    # seconds for their tracebacks, then every failed rank's
                    grace = time.monotonic() + 5.0
                    while (time.monotonic() < grace
                           and any(p.poll() is None for p in procs)):
                        time.sleep(0.02)
                    codes = [p.poll() for p in procs]
                    raise RuntimeError("".join(
                        f"rank {r} of {n} exited with code {c}"
                        + (":\n" + err.read_text() if err.exists() else "\n")
                        for r, c, err in ((r, c, folder / f"rank{r}.err")
                                          for r, c in enumerate(codes)
                                          if c not in (None, 0))))
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = [torch.load(folder / f"rank{r}.pt", weights_only=False)
                   for r in range(n)]
    per_job = [[results[r][j] for r in range(n)] for j in range(len(jobs))]
    return per_job[0] if one else per_job


if __name__ == "__main__":
    from hipace_tpu_torch.parallel.ranks import _child as _run_child
    sys.exit(_run_child(sys.argv[1], int(sys.argv[2])))
