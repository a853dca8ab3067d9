"""The process mesh of the sharded commit and NTT.

One flat axis ("shards") is enough: the parallel axes of a SNARK prover are
data-parallel polynomials and points. A mesh is a torch.distributed
DeviceMesh with that one axis over the default process group, one rank per
device: gloo on the CPU, NCCL on the card. The group starts from a file
store, so nothing needs a network.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

SHARD_AXIS = "shards"


def init_process_group(store_path: str, rank: int, world: int, device=None) -> torch.device:
    """Join the default group of `world` ranks as `rank` through the file
    store at `store_path` (a path every rank can reach, absent before the
    group starts). The backend follows the device: NCCL on the card, which
    raises where torch was built without it (no quiet fall back to gloo),
    gloo on the CPU. Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed.is_nccl_available() is false: the card's mesh needs NCCL")
        backend = "nccl"
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(store_path)}", rank=rank,
                            world_size=world)
    return dev


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> DeviceMesh:
    """The one-axis mesh over every rank of the default group (which must be
    started, `init_process_group`); `n_devices`, when given, must be its
    size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks over a group of {world}: start the group at that size")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def shard_axis(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of dimension `dim` of x (a view): the mesh's ranks
    split it evenly, in rank order."""
    d, r = mesh.size(), mesh.get_local_rank()
    n = x.shape[dim]
    if n % d:
        raise ValueError(f"dimension of {n} does not split evenly over {d} ranks")
    return x.narrow(dim, r * (n // d), n // d)
