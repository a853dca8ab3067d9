"""CPU seconds of the port's MSM reduction on a K3-shaped slot table, new
against old.

The table is (C * 43, S, 32) projective points, each a point of a small
pool of multiples of G scaled by a random Z (seeded), in Montgomery words.
Timed on the CPU (`scroll_prover_tpu_torch.ops.msm_tile`):

- new: `_msm_reduce_plain` (the path of a CPU `msm_v2_host_batch`): the
  slot tree in torch, the window sums and the window fold on host ints
  (`_window_fold_host`); then `_affine_columns`;
- old: the slot tree, the bucket table's readback and `_host_fold_mont`
  per column (the CPU path before the fold moved into K4).

Both give the same affine points (checked). Prints one JSON line.

    python scripts/torch_msm_reduce_cpu.py --columns 8 --slots 64
"""
from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator
from scroll_prover_tpu_torch.fields.bn254 import FQ_MOD, FR_MOD
from scroll_prover_tpu_torch.fields.limbs import limbs_from_torch
from scroll_prover_tpu_torch.ops import msm_tile as mt


def slot_table(C: int, S: int, seed: int) -> torch.Tensor:
    rng = random.Random(seed)
    g = g1_generator()
    pool = [G1.mul(g, rng.randrange(1, FR_MOD)) for _ in range(64)]
    W, B = mt._wb(mt.MSM_C)
    R = (1 << 256) % FQ_MOD
    buf = bytearray()
    for _ in range(C * W * S * (B - 1)):
        x, y = pool[rng.randrange(len(pool))]
        z = rng.randrange(1, FQ_MOD)
        for v in (x * z, y * z, z):
            buf += (v * R % FQ_MOD).to_bytes(32, "little")
    return torch.from_numpy(np.frombuffer(bytes(buf), dtype="<i4").reshape(C * W, S, B - 1, 3, 8).copy())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--columns", type=int, default=8)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=2)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    W, _B = mt._wb(mt.MSM_C)
    tbl = slot_table(a.columns, a.slots, a.seed)

    t0 = time.perf_counter()
    red = mt._lane_reduce_plain(tbl)
    t1 = time.perf_counter()
    new = mt._affine_columns(mt._window_fold_host(red.numpy().reshape(a.columns, W, *red.shape[2:]), mt.MSM_C))
    t3 = time.perf_counter()
    t = mt._bucket_table(red)
    old = [mt._host_fold_mont(c, mt.MSM_C) for c in limbs_from_torch(t).reshape(a.columns, W, *t.shape[1:])]
    t4 = time.perf_counter()
    whole = time.perf_counter()
    again = mt._affine_columns(mt._msm_reduce_plain(tbl).numpy())
    whole = time.perf_counter() - whole
    if new != old or again != new:
        raise SystemExit("the reductions disagree")
    print(json.dumps({
        "columns": a.columns, "slots": a.slots, "threads": a.threads,
        "slot_tree_s": t1 - t0, "window_sums_and_fold_s": t3 - t1,
        "new_s": whole, "old_s": (t1 - t0) + (t4 - t3), "old_host_fold_s": t4 - t3,
    }))


if __name__ == "__main__":
    main()
