"""One run of one cell: set-up, the measured window, the checks, the
result line. `run.py` is its entry; `run()` skips the look for a card, so
that the tests can drive a whole run on the CPU at a small size."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "scroll_prover_tpu")
SAMPLES_PER_TASK = {"ntt": 2, "msm": 2}
REFERENCE_WORKERS = 6  # processes for the reference's sums, after the window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="",
                    help="faults to plant under the timed path, comma-separated, of "
                         "ntt, msm, instance, eval (the control runs and the tests)")
    args = ap.parse_args(argv)
    from .hooks import FAULTS

    args.faults = tuple(f for f in args.fault.split(",") if f)
    bad = [f for f in args.faults if f not in FAULTS]
    if bad:
        ap.error(f"unknown faults {bad}; known: {', '.join(FAULTS)}")
    return args


class Context:
    """What a driver sees: the cell's configuration and mix, the seed, the
    device, the spans and the hooks."""

    def __init__(self, cell, args, device, tracer, hooks):
        from . import traffic

        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = args.seed
        self.device = device
        self.tracer = tracer
        self.hooks = hooks
        self.faults = set(args.faults)
        self.srs_seed = traffic.task_seed(args.seed, -1, "srs")


def prepare(args, device, root: str):
    """Set-up: the cell's pieces, kernels from the checkout's caches, the
    hooks, and the driver's set-up (SRS, keygen, warm-up task)."""
    import torch

    from . import tracing
    from .cells import Cell
    from .hooks import Hooks

    cell = Cell(root, args.workload)
    traced = bool(args.trace)
    tracer = tracing.Tracer(ranges=traced)
    hooks = Hooks(tracer, args.seed, SAMPLES_PER_TASK, tally=traced, faults=args.faults)
    ctx = Context(cell, args, device, tracer, hooks)
    if device.type == "cuda":
        from scroll_prover_tpu_torch.ops import cuda_lib

        cuda_lib.build_all()
    hooks.install()
    hooks.start_task(None)
    state = cell.driver.setup(ctx)
    hooks.end_warmup()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cell, ctx, tracer, hooks, state


def run(args, device, root: str, t_start: float, chips: int = 1) -> int:
    import torch

    from . import tracing
    from .traffic import make_task

    cell, ctx, tracer, hooks, state = prepare(args, device, root)
    traced = bool(args.trace)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    setup_s = time.perf_counter() - t_start

    # --- the window: one client, one task at a time, whole tasks only
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    hooks.work = {"ntt": [], "msm": []}  # the window's calls only
    hooks.proofs, hooks.outside = [], 0
    tracer.tally_s, tracer.tallies = 0.0, []
    records, failed, wall = [], 0, 0.0
    task_s = []
    tracer.watch_gc(True)
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with torch.profiler.record_function("bench.window") if traced else contextlib.nullcontext():
        t0 = time.perf_counter()
        index = 0
        # a traced run profiles one task: reading the trace of two would
        # take the run near its 360 s
        while index == 0 or (not traced and wall - tracer.tally_s < args.seconds):
            with tracer.tally():
                inputs = make_task(cell.traffic, args.seed, index)
            hooks.start_task(index)
            tracer.task = index
            t_task = time.perf_counter()
            try:
                records.append(cell.driver.task(state, ctx, inputs))
            except Exception:  # a task that fails ends the window and the run's correctness
                traceback.print_exc()
                failed += 1
                break
            finally:
                sync()
                wall = time.perf_counter() - t0
                task_s.append(time.perf_counter() - t_task)
            index += 1
    tracer.watch_gc(False)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = wall - tracer.tally_s
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    hooks.uninstall()

    trace = tracing.read_profile(prof) if traced and on_card else None
    readings = SimpleNamespace(tasks=len(records), window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                               tracer=tracer, trace=trace, work=hooks.work)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # --- checks: the port's own verifier, then the reference (on the host,
    # after the device's peak is read and the port's state is let go)
    t_checks = time.perf_counter()
    verify_rejects = cell.driver.verify(state, ctx, records) if records else 0
    t_verified = time.perf_counter()
    verify_s = t_verified - t_checks
    del state  # the reference runs on the host, in processes of its own
    t_freed = time.perf_counter()
    workers = min(REFERENCE_WORKERS, os.cpu_count() or 1) if on_card else 1
    numbers = {**reference_numbers(cell, ctx, hooks, records, workers), "verify_rejects": verify_rejects,
               "tasks_failed": failed}
    hooks.proofs = []
    t_ref = time.perf_counter()
    print("tasks: " + ", ".join(f"{t:.2f} s (collector {tracer.gc_s.get(i, 0.0):.2f} s)"
                                for i, t in enumerate(task_s)), file=sys.stderr)
    print(f"seconds: set-up {setup_s:.2f}, window {window_s:.2f} ({len(records)} tasks, the benchmark's own "
          f"work {tracer.tally_s:.2f} left out), port verifier {verify_s:.2f}, freeing the port's state "
          f"{t_freed - t_verified:.2f}, reference {t_ref - t_freed:.2f}", file=sys.stderr)
    if trace is not None:
        print(f"profile: device spans of the MSM ranges start (least, median, most) {trace['msm_lag_ms']} ms "
              f"after their host ranges", file=sys.stderr)
    limits = dict.fromkeys(numbers, 0)  # exact comparisons
    correct = all(numbers[k] <= limits[k] for k in numbers) and bool(records)

    found = forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(records) + failed, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace is not None:
        w0, w1 = trace["window_ns"]
        device_info["busy_s"] = tracing.busy_ns(trace["work"]) / 1e9
        device_info["window_s"] = (w1 - w0) / 1e9 - tracer.tally_s
        out["breakdown"] = tracing.breakdown(trace, tracer, t0)
    print(f"samples checked: {len(hooks.samples['ntt'])} NTT, {len(hooks.samples['msm'])} MSM over "
          f"{len(records)} tasks; NTT calls of the window's proves outside the sampled sizes: {hooks.outside}",
          file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v} limit {limits[k]}", file=sys.stderr)
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


def reference_numbers(cell, ctx, hooks, records, workers: int = 1) -> dict:
    """The reference's comparisons of the sampled NTT and MSM calls, of every
    proof's evaluations and opening, and of the driver's own outputs: each
    number counts disagreements. The sums run in `workers` processes
    (spawned, and ended before this returns)."""
    import multiprocessing

    from benchref import checks, opening

    tau = checks.tau_of(ctx.srs_seed)
    t0 = time.perf_counter()
    proofs = sum(len(r["proofs"]) for r in records)
    opened = {"eval_bad": 0, "commit_bad": 0, "opening_bad": max(0, proofs - len(hooks.proofs))}
    with (multiprocessing.get_context("spawn").Pool(workers) if workers > 1 else contextlib.nullcontext()) as pool:
        ntt_bad, msm_bad = checks.judge(hooks.samples["ntt"], hooks.samples["msm"], tau, tau, pool, 2 * workers)
        t_open = time.perf_counter()
        for rec in hooks.proofs:
            for k, v in opening.check_proof(rec, tau, pool).items():
                opened[k] += v
        if pool is not None:
            pool.close()
            pool.join()
    t1 = time.perf_counter()
    own = cell.driver.reference(ctx, records, tau)
    sizes = [f"{'inverse' if s['inverse'] else 'forward'} 2^{s['n'].bit_length() - 1}" for s in hooks.samples["ntt"]]
    sizes += [f"{s['basis']} {len(s['scalars'])}" for s in hooks.samples["msm"]]
    print(f"reference: {t_open - t0:.2f} s for the samples ({', '.join(sizes)}) in {workers} processes, "
          f"{t1 - t_open:.2f} s for {len(hooks.proofs)} proofs' evaluations and openings, "
          f"{time.perf_counter() - t1:.2f} s for the driver's own", file=sys.stderr)
    return {
        "ntt_bad": ntt_bad,
        "msm_bad": msm_bad,
        "unsampled": int(not hooks.samples["ntt"]) + int(not hooks.samples["msm"]),
        **opened,
        **own,
    }
