"""Command-line entry points of the port (`python -m scroll_prover_tpu_torch.bin.<name>`)."""
