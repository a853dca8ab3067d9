"""Env-driven settings (reference bin/src/chain_prover.rs:413-461)."""
from __future__ import annotations

from dataclasses import dataclass

from ..utils.env import read_env_var


@dataclass
class Setting:
    l2geth_api_url: str
    rollupscan_api_url: str
    begin_batch: int
    end_batch: int
    begin_block: int
    end_block: int
    test_mode: str  # block_prove | batch_prove | txtx_ccc
    params_dir: str
    assets_dir: str

    @classmethod
    def new(cls) -> "Setting":
        return cls(
            l2geth_api_url=read_env_var("L2GETH_API_URL", ""),
            rollupscan_api_url=read_env_var("ROLLUPSCAN_API_URL", ""),
            begin_batch=read_env_var("PROVE_BEGIN_BATCH", 1),
            end_batch=read_env_var("PROVE_END_BATCH", 1),
            begin_block=read_env_var("PROVE_BEGIN_BLOCK", 1),
            end_block=read_env_var("PROVE_END_BLOCK", 1),
            test_mode=read_env_var("TEST_MODE", "block_prove"),
            params_dir=read_env_var("SCROLL_PROVER_PARAMS_DIR", "./params"),
            assets_dir=read_env_var("SCROLL_PROVER_ASSETS_DIR", "./test_assets"),
        )
