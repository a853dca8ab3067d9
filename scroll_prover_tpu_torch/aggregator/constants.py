"""Batch/blob geometry constants.

Values verified against the reference (SURVEY.md section 2.4): the blob
metadata layout decodes only with MAX_AGG_SNARKS = 45; blob geometry from
bin/src/constants.rs:5-13.
"""
MAX_AGG_SNARKS = 45
BLOB_WIDTH = 4096
N_DATA_BYTES_PER_COEFFICIENT = 31
N_BLOB_BYTES = BLOB_WIDTH * N_DATA_BYTES_PER_COEFFICIENT  # 126,976

# blob envelope bytes (batch-task fixtures: raw starts 0x00, zstd 0x01)
ENVELOPE_RAW = 0x00
ENVELOPE_ZSTD = 0x01
