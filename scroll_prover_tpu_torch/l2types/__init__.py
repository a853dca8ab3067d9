"""L2 chain types: BlockTrace and friends (eth-types equivalent).

Capability parity with the reference's `eth-types` crate (SURVEY.md
section 2.2, Cargo.lock:1324): the BlockTrace JSON schema (verified against
integration/tests/extra_traces fixtures, SURVEY.md section 2.4) plus the
chain-constant plumbing of `set_scroll_block_constants_with_trace`
(bin/src/trace_prover.rs:33).
"""
from .block_trace import (  # noqa: F401
    AccountWrapper, BlockTrace, ExecutionResult, StorageTrace, StructLog,
    TransactionTrace, get_block_trace_from_file,
    set_scroll_block_constants_with_trace, scroll_block_constants,
)
