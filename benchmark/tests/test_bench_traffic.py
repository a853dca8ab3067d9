"""The traffic generator: deterministic per seed, distinct across seeds,
the same work for every seed, stack-consistent programs whose every
transaction the port replays opcode by opcode with a signature it
recovers, and chunks the circuit fits at k = 18."""
import json
import os
import random

import pytest
from benchlib import traffic
from benchref import checks
from conftest import BENCH


def _mix(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


BIG = 2**31 + 2**30 + 7  # the driver's seeds exceed 32 signed bits


def test_chunk_traces_per_seed():
    p = _mix("fresh_traces")
    a = traffic.make_task(p, BIG, 0)
    assert a == traffic.make_task(p, BIG, 0)
    b, c = traffic.make_task(p, BIG, 1), traffic.make_task(p, BIG + 1, 0)
    for other in (b, c):
        assert other["traces"] != a["traces"] and other["prove_seed"] != a["prove_seed"]
    for task in (a, b, c):
        (trace,) = task["traces"]
        counts = sorted(len(er["structLogs"]) for er in trace["executionResults"])
        assert counts == sorted(p["logs_per_tx"])  # the same work, in a seeded order
    order = [len(er["structLogs"]) for er in a["traces"][0]["executionResults"]]
    assert order != [len(er["structLogs"]) for er in c["traces"][0]["executionResults"]]


def test_a_mix_names_its_generator_by_kind():
    with pytest.raises(ValueError, match="unknown traffic kind"):
        traffic.make_task({"kind": "no_such_kind"}, 1, 0)


@pytest.mark.parametrize("cycle,error", [([["SLOAD"]], "underflows"), ([["PUSH1", 0, 1]], "leaves 1")])
def test_a_cycle_that_breaks_the_stack_is_refused(cycle, error):
    gen = traffic.generator("chunk_traces")
    with pytest.raises(ValueError, match=error):
        gen.program(random.Random(1), dict(_mix("fresh_traces"), cycle=cycle), 40, 10**6)


def test_logs_carry_the_gas_left():
    gen = traffic.generator("chunk_traces")
    _code, logs, used, _i, _o = gen.program(random.Random(2), _mix("fresh_traces"), 500, 10**6)
    for a, b in zip(logs, logs[1:]):
        assert b["gas"] == a["gas"] - a["gasCost"] and a["gasCost"] > 0
    assert used == 10**6 - logs[-1]["gas"] + logs[-1]["gasCost"]


@pytest.mark.parametrize("logs", ["least", "most", "mix"])
def test_chunk_replays_and_min_k_is_18_across_the_range(logs):
    """Every chunk of the mix replays, its signatures recover to its
    sender, and it fits k = 18: at the least and the most logs a
    transaction of the mix's range, and at its own list. The public
    instance the port derives equals the reference's."""
    from scroll_prover_tpu_torch.l2types import BlockTrace
    from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
    from scroll_prover_tpu_torch.witness.sig import tx_sig_event
    from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit, chunk_instance

    p = _mix("fresh_traces")
    n = len(p["logs_per_tx"])
    counts = {"least": [min(p["logs_per_tx"])] * n, "most": [max(p["logs_per_tx"])] * n, "mix": p["logs_per_tx"]}
    traces = traffic.make_task(dict(p, logs_per_tx=counts[logs]), BIG, 3)["traces"]
    blocks = [BlockTrace.from_json(t) for t in traces]
    wb = chunk_trace_to_witness_block(blocks)
    assert wb.replayed_txs == wb.num_txs == n
    assert all(tx_sig_event(tx) is not None for b in blocks for tx in b.transactions)
    assert ScrollSuperCircuit.new_from_block(wb).min_k() == 18
    assert chunk_instance(wb) == checks.chunk_instance(traces)
