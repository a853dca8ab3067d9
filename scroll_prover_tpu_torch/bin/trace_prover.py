"""trace_prover: one-shot trace file/dir -> chunk proof + verify.

    python -m scroll_prover_tpu_torch.bin.trace_prover [--trace PATH] [--device cpu]

CLI parity with the reference bin/src/trace_prover.rs:6-45:
  --params <dir>   SRS dir (default ./params)
  --assets <dir>   assets dir (default ./test_assets)
  --trace <path>   block trace file or chunk directory
  --device <dev>   where to prove (default: the card)
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", default="./params")
    ap.add_argument("--assets", default="./test_assets")
    ap.add_argument(
        "--trace",
        default="tests/extra_traces/batch1",
        help="block trace file or chunk dir (block_*.json)",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..integration.prove import prove_and_verify_chunk
    from ..l2types import set_scroll_block_constants_with_trace
    from ..prover import load_params_map
    from ..prover.provers import apply_production_cap_profile
    from ..utils import init_env_and_log, load_chunk

    device = resolve_device(args.device)
    output_dir = init_env_and_log("trace_prover")
    log = logging.getLogger("trace_prover")
    traces = load_chunk(args.trace)
    if not traces:
        log.error("no traces found at %s", args.trace)
        sys.exit(1)
    set_scroll_block_constants_with_trace(traces[0])
    # production cap profile: unset SPT_*_CAP knobs default to the witness
    # DEMAND, so a no-env trace_prover proof constrains every signature/
    # keccak/mpt/precompile event (reference mock.rs full super circuit)
    apply_production_cap_profile(traces)
    # degrees auto-shrink to the witness in test mode; the map is seeded
    # lazily rather than preloading the production 2^20/24/25 files
    params_map = {}
    if os.path.isdir(args.params):
        degrees = [
            int(f[len("params"):])
            for f in os.listdir(args.params)
            if f.startswith("params") and f[len("params"):].isdigit()
        ]
        params_map = load_params_map(args.params, degrees, device)
    proof = prove_and_verify_chunk(
        params_map, args.assets, traces, None, output_dir, device
    )
    log.info(
        "chunk proof OK: blocks=%d layers=%d output=%s",
        len(traces), len(proof.inner.layers), output_dir,
    )


if __name__ == "__main__":
    main()
