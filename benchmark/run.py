"""Run one cell of the benchmark once on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Set-up (the beam drawn from the seed, the
program built, the warm-up steps) counts into ``setup_s``, from the start
of this process. With ``--trace 0`` the window measures the cell's
end-to-end metrics for ``--seconds``; with ``--trace 1`` the traffic's
traced steps run under the profiler and the cell's per-layer metrics are
read from them. Either way the reference then decides ``correct``
(``check.py``). The last lines of stderr give each number compared beside
its limit; the last line of stdout is the result, one JSON object.

Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; if a module of JAX or of the JAX package is loaded once
the window has closed, it exits 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402

# top-level module names the process may not hold: JAX, and the JAX package
# beside the port (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "hipace_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_info(device, chips: int, run) -> dict:
    """The contract's device record; the run names the card."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": run.peak_bytes()}
    return {"platform": "gpu", "kind": run.device_name(), "count": chips,
            "memory_peak_bytes": run.peak_bytes()}


def run_cell(man: manifest.Manifest, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", cfg: dict | None = None,
             dtype=None, t0: float | None = None) -> tuple:
    """Run cell `name` once; returns (result line, check lines). cfg
    replaces the cell's configuration file and dtype its dtype (the
    benchmark's tests run small configurations on the CPU and the float32
    control on the card through these)."""
    import torch
    t0 = T0 if t0 is None else t0
    cell = man.cell(name)
    cfg = cfg or man.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    device = torch.device(device)
    run = manifest.kind(mix["kind"]).Run(cfg, mix, seed, device, dtype)
    try:
        run.set_up()
        setup_s = time.perf_counter() - t0
        dev = {}
        if trace:
            tr = run.traced()
            attempted = tr.n_slices
            metrics = {}
            for m in man.metrics("per_layer", name):
                value = manifest.reader(m["name"])(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        else:
            win = run.window(seconds)
            attempted = win["slices"]
            e2e = {run.rate_metric: win["slices"] / win["seconds"],
                   "setup_s": setup_s}
            if device.type == "cuda":
                e2e["peak_mem_gib"] = run.peak_bytes() / 2**30
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in man.metrics("end_to_end", name)
                       if m["name"] in e2e}
        info = dict(device_info(device, cell["chips"], run), **dev)
        t_check = time.perf_counter()
        nums = run.compare()
        nums.setdefault("check_s", time.perf_counter() - t_check)
    finally:
        run.close()
    limits = cfg["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": info}
    if trace:
        from .trace import breakdown, groups_per_slice
        line["breakdown"] = breakdown(tr)
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                          else str(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    lines = ["# phases: " + ", ".join(
        f"{what} {sec:.3f} s" if isinstance(sec, float) else
        f"{what} {sec[0]:.3f} / {sec[len(sec) // 2]:.3f} / {sec[-1]:.3f} s"
        for what, sec in run.phases)]
    if trace:
        lines.append("# device ms / activities per slice: " + ", ".join(
            f"{g} {ms:.4f} / {n:.2f}"
            for g, (ms, n) in groups_per_slice(tr).items()))
    lines += [f"# reference: V-cycles {nums.get('ref_cycles')}; worst field "
              f"{nums.get('fields_worst')}; {nums['check_s']:.3f} s"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
              for k, c in checks.items()]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest.Manifest()
    cell = man.cell(args.workload)
    # the program's caches inside the checkout, at fixed paths (the port
    # builds its kernels under build/hipace_tpu_torch itself)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(manifest.ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(manifest.ROOT / "build" / "torch_extensions"))
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, lines = run_cell(man, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}: the port may not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    for text in lines:
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
