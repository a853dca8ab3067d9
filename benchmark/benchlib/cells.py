"""Finding a cell's pieces by name: BENCHMARK.json at the root of the
checkout names the cell's configuration (a JSON file under `configs/`,
whose "driver" names a module under `drivers/`), its traffic mix (a JSON
file under `traffic/`) and the metrics it reports (a reader module each
under `metrics/`). Adding a configuration, a mix, a metric or a cell adds
files and entries; no file of the harness changes."""
from __future__ import annotations

import importlib.util
import json
import os

def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    def __init__(self, root: str, workload: str):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            spec = json.load(fh)
        bench_dir = os.path.join(root, spec["paths"][0])
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.spec = spec
        self.workload = cells[workload]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        with open(os.path.join(root, cfg_entry["file"])) as fh:
            self.config = json.load(fh)
        with open(os.path.join(bench_dir, "traffic", f"{self.workload['traffic']}.json")) as fh:
            self.traffic = json.load(fh)
        from . import traffic

        traffic.use_generators(os.path.join(bench_dir, "generators"))
        self.driver = load_module(os.path.join(bench_dir, "drivers", f"{self.config['driver']}.py"),
                                  f"bench_driver_{self.config['driver']}")
        self.end_to_end = [m for m in spec["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"] if self._reports(m) and m["moves"] in reported]
        self.bench_dir = bench_dir

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.workload["name"] in metric["workloads"]

    def reader(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics", f"{name}.py"), f"bench_metric_{name.replace('.', '_')}").read
