"""Sharding over processes: a one-axis mesh of ranks over torch.distributed,
the sharded MSM (msm_sharded.py) and the four-step sharded NTT
(ntt_sharded.py). Where the JAX package runs one controller over a device
mesh (shard_map with XLA collectives), every device here has a process of
its own, and every rank runs the same code (SPMD)."""
from .mesh import init_process_group, make_mesh, shard_axis  # noqa: F401
