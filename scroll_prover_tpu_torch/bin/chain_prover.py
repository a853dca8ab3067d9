"""chain_prover: follow a live chain — fetch traces, propose chunks/batches
like production, optionally prove.

    python -m scroll_prover_tpu_torch.bin.chain_prover [--device cpu]

CLI/env parity with the reference bin/src/chain_prover.rs:381-461:
  TEST_MODE=block_prove | batch_prove | txtx_ccc
  L2GETH_API_URL, ROLLUPSCAN_API_URL, PROVE_BEGIN/END_{BLOCK,BATCH},
  CIRCUIT=none|ccc|real
  --device <dev>   where to prove (default: the card)
"""
from __future__ import annotations

import argparse
import logging


def prove_by_block(setting, client, device=None):
    from ..orchestration import BatchBuilder, ChunkBuilder
    from ..orchestration.prove_utils import prove_chunk
    from ..prover.chunk_info import ChunkInfo
    from ..witness import chunk_trace_to_witness_block

    log = logging.getLogger("chain_prover")
    chunk_builder = ChunkBuilder()
    batch_builder = BatchBuilder()
    params: dict = {}

    def handle_chunk(blocks):
        if not blocks:
            return
        prove_chunk(params, setting.assets_dir, blocks, device=device)
        wb = chunk_trace_to_witness_block(blocks)
        info = ChunkInfo.from_witness_block(wb)
        sealed_batch = batch_builder.add(info)
        if sealed_batch:
            log.info("batch sealed with %d chunks", len(sealed_batch))

    for number in range(setting.begin_block, setting.end_block + 1):
        trace = client.get_block_trace_by_num(number)
        sealed = chunk_builder.add(trace)
        if sealed:
            handle_chunk(sealed)
    handle_chunk(chunk_builder.flush())
    rest = batch_builder.flush()
    if rest:
        log.info("final partial batch: %d chunks", len(rest))


def prove_by_batch(setting, l2geth, rollupscan, device=None):
    from ..orchestration.prove_utils import prove_chunk

    log = logging.getLogger("chain_prover")
    params: dict = {}
    for batch_index in range(setting.begin_batch, setting.end_batch + 1):
        chunks = rollupscan.get_chunk_info_by_batch_index(batch_index)
        if not chunks:
            log.warning("no chunks for batch %d", batch_index)
            continue
        for cr in chunks:
            traces = [
                l2geth.get_block_trace_by_num(n)
                for n in range(cr.start_block_number, cr.end_block_number + 1)
            ]
            prove_chunk(params, setting.assets_dir, traces, str(cr.index), device=device)


def txtx_ccc(setting, client):
    """Per-tx vs whole-block CCC cross-check (chain_prover.rs:324-379)."""
    from ..witness.capacity import ccc_as_signer, ccc_by_chunk, compare_ccc_results

    log = logging.getLogger("chain_prover")
    for number in range(setting.begin_block, setting.end_block + 1):
        trace = client.get_block_trace_by_num(number)
        whole = ccc_by_chunk([trace])
        per_tx = ccc_as_signer([trace])
        compare_ccc_results(whole, per_tx)
        log.info("block %d ccc cross-check ok", number)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..orchestration import L2gethClient, RollupscanClient, Setting
    from ..utils import init_env_and_log
    from ..witness.capacity import CircuitCapacityChecker

    # the card unless --device cpu: without one the CLI stops here, as the
    # port's other entry points do, rather than proving on the CPU
    device = resolve_device(args.device)
    init_env_and_log("chain_prover")
    setting = Setting.new()
    CircuitCapacityChecker()  # warmup (reference chain_prover.rs:22-25)
    l2geth = L2gethClient(setting.l2geth_api_url)
    if setting.test_mode == "batch_prove":
        prove_by_batch(setting, l2geth, RollupscanClient(setting.rollupscan_api_url), device)
    elif setting.test_mode == "txtx_ccc":
        txtx_ccc(setting, l2geth)
    else:
        prove_by_block(setting, l2geth, device)


if __name__ == "__main__":
    main()
