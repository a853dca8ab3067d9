"""Run one cell of the port's benchmark on this machine's card and print
its result line (the last line of standard output, one JSON object).

    python3 benchmark/run.py --workload chunk18.fresh_traces --seed 1 --seconds 50 --trace 0

Run from the root of a checkout that holds BENCHMARK.json and the port
(scroll_prover_tpu_torch). `--trace 1` runs the window under torch.profiler
and reports the per-layer metrics in place of the end-to-end ones. It
measures the PyTorch/CUDA port only, and fails where JAX or the JAX package
got loaded. Kernel builds and caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """A run at the port's defaults: no inherited SPT_* setting; caches at
    fixed paths inside the checkout."""
    for name in [v for v in os.environ if v.startswith("SPT_")]:
        del os.environ[name]
    cache = os.path.join(ROOT, ".benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for path in (os.path.dirname(os.path.abspath(__file__)), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def main() -> int:
    _environment()
    import json
    import logging

    from benchlib.harness import parse, run

    args = parse()
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        chips = {w["name"]: w["chips"] for w in json.load(fh)["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: this cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    logging.getLogger("scroll_prover_tpu_torch").setLevel(logging.WARNING)  # warnings only: the port's progress lines are info
    from scroll_prover_tpu_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    torch.cuda.set_device(dev)
    return run(args, dev, ROOT, T_START, chips)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # the interpreter's teardown of a prover's objects takes minutes
