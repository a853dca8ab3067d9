"""On the card: each cell clean comes out correct, and with the control's
faults planted under its timed path comes out not correct (one short task
each; the control readings of PERF.md were taken so, with run.py
--fault ntt,msm,instance,eval on three seeds)."""
import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = ["chunk18.fresh_traces"]


def _run(cell, seed, fault=None):
    argv = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", "0"] + (["--fault", fault] if fault else [])
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "ntt,msm,instance,eval"])
def test_cell_on_the_card(card, cell, fault):
    result = _run(cell, 3_000_000_019, fault)
    assert result["correct"] is (fault is None)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
