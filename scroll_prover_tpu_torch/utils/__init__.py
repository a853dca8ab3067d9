"""Utilities: env/config/logging, trace fixture loading, artifact io.

Mirrors the reference's prover-crate utility surface (SURVEY.md section
2.3 "Params/env/IO") and integration/src/test_util.rs.
"""
from .env import init_env_and_log, read_env_var, short_git_version  # noqa: F401
from .io import dump_as_json, read_json, read_json_deep, force_read  # noqa: F401
from .test_util import (  # noqa: F401
    ASSETS_DIR, PARAMS_DIR, load_chunk, load_batch, trace_path_for_test,
)
