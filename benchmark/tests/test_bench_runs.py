"""Whole runs on the CPU of a cell added from new files alone (tiny_cell):
the result line's keys, the checks printed last, and every planted fault
turning `correct` false."""
import hashlib
import os

import pytest
import tiny_cell
from conftest import BENCH


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cell.build(str(tmp_path_factory.mktemp("tiny")))


def _digests(base):
    out = {}
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith((".py", ".json")) and "__pycache__" not in dirpath:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_from_new_files_alone(root, capsys):
    """The copy's existing files equal the benchmark's: the new cell, its
    configuration, mix, driver and metric are files and entries only."""
    ours = {k: v for k, v in _digests(BENCH).items() if not k.startswith("tests")}
    theirs = _digests(os.path.join(root, "benchmark"))
    assert all(theirs[k] == v for k, v in ours.items())
    assert set(theirs) - set(ours) == {"drivers/tiny_inner.py", "metrics/tasks_done.py", "configs/tiny_k6.json",
                                       "traffic/tiny_inner.json", "generators/tiny_instances.py"}
    result, _err = tiny_cell.run(root, capsys)
    assert result["correct"] is True
    assert result["metrics"]["tasks_done"] == {"value": 1.0, "unit": "tasks"}


def test_the_last_line_and_the_checks(root, capsys):
    result, err = tiny_cell.run(root, capsys, seed=2**40 + 3)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"proof_s", "peak_device_gib", "setup_s", "tasks_done"} - {"peak_device_gib"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = list(result["checks"])
    assert err[-len(names):] == [f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]
    assert {"ntt_bad", "msm_bad", "eval_bad", "commit_bad", "opening_bad", "instance_bad", "verify_rejects"} <= set(names)
    assert all(v["value"] == 0 and v["limit"] == 0 for v in result["checks"].values())


def test_traced_run_reports_per_layer_metrics(root, capsys):
    result, _err = tiny_cell.run(root, capsys, trace=1)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"prove_s"}  # the device's readings need the card


@pytest.mark.parametrize("fault,numbers", [
    ("ntt", ["ntt_bad", "verify_rejects"]),  # half of each transform's input left out
    ("msm", ["msm_bad", "commit_bad", "opening_bad", "verify_rejects"]),  # every commitment altered where made
    ("instance", ["instance_bad"]),  # a public cell altered where it is made (and proved so)
    ("eval", ["eval_bad", "opening_bad", "verify_rejects"]),  # a claimed evaluation altered where it is made
    ("stale", ["opening_bad", "unsampled", "verify_rejects"]),  # the previous proof handed back
])
def test_a_broken_timed_path_is_not_correct(root, capsys, fault, numbers):
    result, _err = tiny_cell.run(root, capsys, fault=fault)
    assert result["correct"] is False
    assert all(result["checks"][n]["value"] >= 1 for n in numbers), result["checks"]


def test_the_control_fails_every_comparison(root, capsys):
    """The control run plants every fault that leaves a proof to judge."""
    result, _err = tiny_cell.run(root, capsys, fault="ntt,msm,instance,eval")
    assert result["correct"] is False
    bad = {k for k, v in result["checks"].items() if v["value"] >= 1}
    assert bad >= {"ntt_bad", "msm_bad", "eval_bad", "commit_bad", "opening_bad", "instance_bad"}
