"""Chain orchestration: chunk/batch proposers, RPC clients, prove wrappers.

Capability parity with the reference's bin/ layer (SURVEY.md section 2.1):
chain_prover's ChunkBuilder/BatchBuilder (bin/src/chain_prover.rs:27-157),
prove_utils' panic-isolated wrappers (bin/src/prove_utils.rs), the l2geth
and rollupscan clients (integration/src/l2geth.rs,
bin/src/rollupscan_client.rs), and the env-driven Setting
(chain_prover.rs:413-461).
"""
from .builders import BatchBuilder, ChunkBuilder  # noqa: F401
from .clients import L2gethClient, RollupscanClient  # noqa: F401
from .prove_utils import mock_prove, prove_batch, prove_chunk  # noqa: F401
from .settings import Setting  # noqa: F401
