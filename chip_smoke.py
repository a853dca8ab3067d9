"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py              # everything below, on cuda:0
    python3 chip_smoke.py --skip-main  # phases 1-2 only (build + kernel checks)
    python3 chip_smoke.py --levels-only  # build, then K7/K8 at every level of
                                         # 2^20 and FastDomain(20)'s device
                                         # times only (also runs against a
                                         # tree from before the per-level
                                         # twiddle tables, so that the
                                         # two compare in one call)
    python3 chip_smoke.py --profile DIR  # also profile two more k=20 proves:
                                         # torch.profiler (device time by kernel,
                                         # device busy share, per-launch time
                                         # beside the per-launch bound at the
                                         # main path's shapes, the device work
                                         # inside the NTT's profiler range and
                                         # outside it) and cProfile
                                         # (host), the same for two more
                                         # chunk proves; summaries printed,
                                         # full tables in DIR

Phases, each fatal on failure (non-zero exit, no ok line):
  1. device and build: require CUDA, print the card's name and power limit,
     build the CUDA kernels (csrc/*.cu) from this checkout in parallel;
  2. each kernel (K1-K8, each K1 mode) against its plain PyTorch version on
     the card, exact equality (integer arithmetic: tolerance 0), at the main
     path's shapes, timed with CUDA events in turns (plain, kernel, kernel,
     plain); the MSMs are also checked against host Pippenger; K2's tile
     size swept (2^8 to 2^11 elements per block) at the chunk's 1- and
     4-column passes, beside the runtime's resident blocks per SM; K7 at
     every level s = 0..19 and K8 at every s = 0..18 of a 2^20 plane, each
     held and timed, with its bound, share and stride regime, and the sums
     over one FastDomain(20).ntt's launches at radix 2 and 4; K7/K8's tile
     size swept (2^7 to 2^10 elements) at every level, each held against
     the default tile; K7/K8 at every level and tile size of planes 2^1 to
     2^12, and FastDomain(1..12) against its plain path;
  3. the main path at full size: SRS.generate_fast(20), keygen of
     BenchCircuit (4096 rows) at k = 20, prove, verify (must be True), the
     proof's sha256 equal to PROOF_SHA256, with every kernel's launch count
     taken over this phase alone (K1, K1as, K2-K5 each must be > 0), peak
     device memory and peak host RSS; then, after the counts are read, K2
     against its plain version at every pass this phase gave it (the
     extended iNTT's 2^23 passes included), with the phase's own tables;
  4. the alternative engines at k = 20 on phase 3's SRS: FastDomain radix 2
     and radix 4 (K7/K8) against the tiled NTT (K2), with the device time of
     each and of FastDomain's parts (entry transpose, K7/K8 launches, final
     gather) by CUDA events, the v1 MSM (K6)
     against the v2 MSM (K3/K4) over 4 columns of 2^20 scalars, msm_tile
     against msm_tile_host, PoseidonDev against host Poseidon; K6-K8's
     launch counts taken over this phase alone (each must be > 0); then K6
     against its plain version at this phase's own shape (4 columns x 64
     windows x 1024 point tiles) and the v1 batch's time breakdown, and K3
     against its plain version at the shape the v2 MSM gave it (4 columns x
     43 windows x 2^20 points);
 4b. SRS.downsize and the mesh, after phase 4, on phase 3's SRS and prove:
     SRS.generate_fast(21) (the SRS phase 6's layer 1 takes from the cache)
     downsized to 20 by the group iNTT (ops/group_ntt.py: K1/K1as), its
     Lagrange and monomial views equal to phase 3's generate_fast(20) bit
     for bit, g2 and s_g2 shared, no host decode, with its seconds, its
     K1/K1as/K5 launches and the peak device memory; then a process group
     of world size 1 over NCCL (a file store in a temporary directory; the
     phase fails where NCCL is missing) and its one-axis mesh:
     msm_tile_sharded over phase 4's 4 columns equal to
     msm_v2_host_batch's points, ShardedDomain(EvaluationDomain(20),
     mesh).ntt_flat of a random column equal to TiledDomain(20).ntt, and
     phase 3's BenchCircuit proved again with set_commit_mesh(mesh): sha256
     equal to PROOF_SHA256 and verify True. The unrouted references and
     the warm-ups run first, outside the count; the launch counts of K1,
     K1as and K2-K5 are taken over the path alone (generate_fast, the
     downsize, the routed MSM, the sharded NTT, the routed prove; each must
     be > 0, the routed MSM one K3 a column, the sharded NTT K2 and no K3,
     the prove one K3 a routed commit); then K2 at every pass it gave that
     phase 3 did not hold, against its plain version;
  5. the chunk's inner proof at k = 18: a synthetic block trace (8
     transactions x 20,000 struct logs) through BlockTrace.from_json and
     chunk_trace_to_witness_block, ScrollSuperCircuit at the package's
     default caps with min_k() == 18, keygen on SRS.generate_fast(18),
     prove (seed b"chip-smoke-chunk", SHPLONK; the quotient streams its 16
     cosets: the lookups' degree 9 sets j = 4), verify (must be True), a
     tampered proof rejected, the proof's sha256 equal to
     CHUNK_PROOF_SHA256; seconds of each step, of the prove's
     phases and of each coset, the coset cache's cap, the share of non-zero
     cells per sub-circuit's columns and of non-zero MSM digits, the launch
     counts of K1, K1as, K2, K3 and K4 over this phase alone (each must be
     > 0), its peak device memory and peak host RSS, and the table of the
     port's spans over the phase (scroll_prover_tpu_torch/trace.py, on for
     the phase: calls, seconds, self seconds, counts); then, after the counts
     are read, K3 against its plain version on the chunk's own densest
     commit group (its points, digits and signs, captured during the
     prove), K4 on that K3 output (8 columns), and K2 at every pass the chunk gave it
     (shape, level, stride, tables), with the chunk's own tables;
  6. the chunk's compression ladder at the package's defaults (one builder
     lane, LOOKUP_BITS 12, SPT_LADDER_K 13, SHPLONK): BenchCircuit(4096)
     proved at k = 20 on phase 3's SRS (seed LADDER_SEED) over the 9-cell
     chunk instance of phase 5's ChunkInfo (chain id 7: BenchCircuit copies
     cell 0 into a column whose lookup table is 0..8191) and verified,
     then ChunkProver's own layer code (`_compress_layer`) for layer 1 (a
     VerifierCircuit over the inner proof) and layer 2 (over layer 1's,
     folding its accumulator): per layer the rows, k and columns, the
     seconds of the gadget's recording pass, the SRS (generate_fast: K5),
     the assignment pass, keygen, prove and verify, the accumulator's
     pairing, peak device memory, peak host RSS and each kernel's launches;
     a tampered layer-2 proof rejected, the three proofs wrapped into a
     ChunkProofV2 that ChunkVerifier.verify_chunk_proof accepts (vk from
     the registry, SNARK check, pairing, chunk binding), both layers'
     sha256 equal to LAYER1_PROOF_SHA256 and LAYER2_PROOF_SHA256, the
     launch counts of K1-K5 over this phase alone (each must be > 0); then
     K2 at every pass the phase gave it that phases 3 and 5 did not hold,
     against its plain version;
 6b. between layers 1 and 2 of phase 6, the low-memory prover and the EVM
     tail: phase 6's layer-1 VerifierCircuit (its tables and the copies
     they registered) keyed again under SPT_LOWMEM=1 with a ProveCheckpoint in a temporary
     directory (fixed and sigma committed from their values, no
     coefficient forms kept), its vk bytes equal to phase 6's layer-1 vk,
     its pk in place of phase 6's; then proved with layer 6's outer
     settings (the Keccak transcript, GWC) under bounded residency
     (LOWMEM_SETTINGS: SPT_VALS_RESIDENT=4, SPT_ADVICE_COEFF_RESIDENT=4,
     SPT_PACK_RESIDENT=1) and that checkpoint, whose meta.json holds
     EVM_TAIL_SEED as a resumed directory would; the checkpoint's bytes and
     the disk's free space; device memory at each of the prove's marks
     beside phase 6's unbounded layer-1 prove's, and the peak of each; then
     the checkpoint cut as a crash inside the quotient leaves it (the
     quotient, evaluation and opening commits and the second half of the
     coset files gone) and the prove resumed from it with a copy of the
     circuit object (a new process's), the cosets and phases it took from the checkpoint
     logged, its bytes equal to the bounded prove's; the switches and
     SPT_* variables put back, the directory removed; the proof verified
     on the host with its 12 accumulator cells folded, a tampered proof
     rejected there; the proof wrapped as the last layer of a BundleProof,
     BatchProver._dump_release_artifacts writing the release files (the
     full in-bytecode verifier, evm_verifier.bin and .yul) into a
     temporary directory, and BatchProver.evm_verify_bundle running the
     verifier in the port's EVM: accepted with gas > 100,000, and a revert
     (not gas) for one flipped proof byte and for one changed instance
     cell; the proof's and the bytecode's sha256 and the gas equal to
     EVM_TAIL_PROOF_SHA256, EVM_VERIFIER_SHA256 and EVM_TAIL_GAS; the sizes,
     the seconds of the keygen, the prove and the resume (each by the
     prover's phases) and of each EVM call, the launches of K1-K4 for the keygen, the prove
     and the resume each, and those of K1, K1as, K2, K3 and K4 over the
     bounded prove (each must be > 0; phase 6's counts leave the step
     out). No assignment cache: a layer's copies.pkl would pickle millions
     of copy tuples (the cache is held on the CPU by the tests);
  7. the batch at the package's defaults (blob width 4096, one builder
     lane, SHPLONK, the real BLS12-381 blob commitment), on a card freed
     of phase 6's prover: the blob of phase 6's chunk (get_blob_from_chunks,
     zstd or the raw envelope as the machine allows), the header
     (BatchHeader.construct_from_chunks), then BatchProver's own code
     (`_gen_batch_proof`, seed BATCH_SEED): layer 3, an AggregationCircuit
     that verifies the chunk's layer-2 proof in constraints, links and
     exposes its statement cells and evaluates the blob at the header's
     (z, y) in constraints, and layer 4, a VerifierCircuit over layer 3
     that folds its accumulator; per layer the rows, k and columns, the
     seconds of the recording pass and its replay, the SRS, keygen, prove and verify,
     the accumulator's pairing, peak device memory, host RSS at its marks
     and the launches of K1-K5; BatchVerifier.verify_batch_proof True, and
     False with one blob byte flipped and with one byte of layer 4's proof
     flipped; the exposed data-hash cells equal to the chunk's data hash;
     both proofs' sha256 equal to BATCH_LAYER3_PROOF_SHA256 and
     BATCH_LAYER4_PROOF_SHA256 for the blob's envelope byte; per prove
     phase and quotient coset the caching allocator's retries,
     out-of-memory events, reserved and allocated bytes, the garbage
     collector's pauses and the host seconds inside each K2, K3 and K4
     wrapper on layer 3; the launch counts over this phase alone
     (K1-K5 each > 0); then K2 at every pass that no earlier phase held,
     K3 on a slice of layer 3's densest commit group (2^23 points), K4 on
     that group's whole slot table and K5 on a slice of layer 3's SRS
     scalars, each against its plain version, and the per-launch time of K2, K3 and K4 on layer
     3's keygen and prove (CUDA events around each launch) beside its
     bound;
  8. a `kernels` JSON line, the nvidia-smi line, and as the last line
     {"ok": true, "device": {...}}.

K4 (phases 2, 5 and 7, `k4_check`) is also held through its affine points
against the host fold of the bucket table the reduction before it gave
(`_host_fold_mont`), and the reduction per call is timed beside that old
host part. Every `clock:` line logs the MSM's host steps since the clock
before (`host_step_hook`: `_host_fold_mont` and `_affine_columns`, calls
and seconds), phase 6b its own; a counted path that calls the host fold,
or whose K4 takes other than 2 launches per K3 call (one MSM), fails.

It imports torch and the port (scroll_prover_tpu_torch) only.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import hashlib
import importlib
import json
import logging
import os
import resource
import subprocess
import sys
import time

import torch

# --- H100 SXM peaks (NVIDIA data sheet, at the 700 W limit) -------------------
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes are half of the FP32 lanes (67 TFLOP/s fp32 = 33.5 T FMA/s):
# 16.75 T int32 multiply instructions per second. A 32x32 -> 64-bit product
# takes two (low and high word).
INT32_OPS_PER_S = 33.5e12 / 2
MULS_PER_MONT = 2 * (8 * 8 + 8 * 8 + 8)  # CIOS over 8 words: a*b, m*p, m

# key: (ops module, wrapper, CUDA kernels, source, TPU kernel it replaces);
# K1 and K1as are the modes of one source, one CUDA kernel per mode
KERNELS = {
    "K1": ("field_ops", "mont_mul_k1", ("k1_mul", "k1_mul_add", "k1_mul_sub"), "mont_mul.cu",
           "ntt_tile.py:184"),
    "K1as": ("field_ops", "add_sub_k1", ("k1as_add", "k1as_sub", "k1as_neg"), "mont_mul.cu",
             "field_ops.py:99/106/115"),
    "K2": ("ntt_tile", "_ntt_pass_k2", ("k2_ntt_pass",), "ntt.cu", "ntt_tile.py:126"),
    "K3": ("msm_tile", "_accum_k3", ("k3_count", "k3_scan", "k3_scatter", "k3_msm_accum"), "msm.cu",
           "msm_tile.py:531"),
    "K4": ("msm_tile", "_msm_reduce_k4", ("k4_slot_sums", "k4_window_fold"), "msm.cu", "msm_tile.py:608"),
    "K5": ("fixed_base", "_accumulate_k5", ("k5_fixed_base",), "fixed_base.cu", "fixed_base.py:119"),
    "K6": ("msm_tile", "_msm_buckets_lanes_k6", ("k6_msm4_lanes",), "msm4.cu", "msm_tile.py:164"),
    "K7": ("ntt_fast", "_butterfly_k7", ("k7_butterfly",), "ntt_fast.cu", "ntt_fast.py:158"),
    "K8": ("ntt_fast", "_butterfly4_k8", ("k8_butterfly4",), "ntt_fast.cu", "ntt_fast.py:113"),
}
MAIN_PATH = ("K1", "K1as", "K2", "K3", "K4", "K5")  # phase 3
ALT_PATH = ("K6", "K7", "K8")  # phase 4
MESH_PATH = ("K1", "K1as", "K2", "K3", "K4", "K5")  # phase 4b
DOWNSIZE_FROM, DOWNSIZE_TO = 21, 20  # phase 4b: generate_fast(21).downsize(20) against generate_fast(20)
# sha256 of the k=20 BenchCircuit proof (seed b"chip-smoke"), taken on the
# card from the tree before the K1/K3 redesign: the redesigned kernels must
# leave every byte of the proof as it was
PROOF_SHA256 = "1b562859a5b3ce535a9aadd41bb10f518633e8946def3f6714031413850433d3"
CHUNK_PATH = ("K1", "K1as", "K2", "K3", "K4")  # phase 5
# sha256 of the k=18 chunk proof (the synthetic trace below, seed
# b"chip-smoke-chunk", SHPLONK), taken on the card: it changes only when the
# prover's output, the super circuit or the trace generator is meant to change
CHUNK_PROOF_SHA256 = "0f008ce1c2bb3eb108b4c6bce55a12be92051bb63d0bf136fb4374c5332738ec"
CHUNK_TXS, CHUNK_LOGS, CHUNK_K = 8, 20_000, 18
LADDER_PATH = ("K1", "K1as", "K2", "K3", "K4", "K5")  # phase 6
# sha256 of the layer-1 and layer-2 proofs over phase 3's BenchCircuit at
# k = 20 on phase 5's chunk instance (inner seed LADDER_SEED, layer seeds
# LADDER_SEED + layer number, SHPLONK), taken on the card: they change only
# when the prover's output, the verifier gadget, the layer circuit or phase
# 5's chunk is meant to change
LADDER_SEED = b"chip-smoke-ladder"
LADDER_CHAIN_ID = 7  # BenchCircuit copies instance cell 0 into a column whose lookup table is 0..8191
LAYER1_PROOF_SHA256 = "9c855d50bc1fa79cf42457a19935cf0a0c1d249f2a8fa53e8b8dcd934d387b6f"
LAYER2_PROOF_SHA256 = "7bbecf617f32ba33ccb62e581418774542e596a9003016cb6a0f476793191283"
EVM_TAIL_PATH = ("K1", "K1as", "K2", "K3", "K4")  # phase 6b
# phase 6b: layer 1 proved again with the EVM-facing settings (the Keccak
# transcript, GWC; seed EVM_TAIL_SEED), the sha256 of that proof and of the
# generated verifier's deployment bytecode (evm_verifier.bin), and the gas
# the port's interpreter charges for the accepted call, taken on the card:
# they change only when the prover's output, the verifier gadget, the layer
# circuit, phase 5's chunk, the verifier generator or the interpreter's gas
# schedule is meant to change (the bytecode depends on layer 1's vk and the
# SRS, not on the proof)
EVM_TAIL_SEED = b"chip-smoke-evm-tail"
EVM_TAIL_PROOF_SHA256 = "7b5a38f603a45d1bab9a09026b1e630780430638663ae27dc033647dc2a080c4"
EVM_VERIFIER_SHA256 = "94540b4140d0d30ca548c4c6120abe358006326c5052fd41b3742ddcfda5f31e"
EVM_TAIL_GAS = 842_106
BATCH_PATH = ("K1", "K1as", "K2", "K3", "K4", "K5")  # phase 7
# sha256 of the batch's layer-3 and layer-4 proofs over phase 6's chunk
# (seeds BATCH_SEED + layer number, SHPLONK), by the blob's envelope byte:
# the blob is zstd-compressed (0x01) where the zstd codec builds and raw
# (0x00) where it does not, and the proofs' bytes follow the blob. They
# change only when the prover's output, a gadget, a layer circuit or the
# chunk below is meant to change
BATCH_SEED = b"chip-smoke-batch"
BATCH_LAYER3_PROOF_SHA256 = {
    0x00: "445b8db04e490da74403618cc9703902994e41ed4bccf390297e7c475495ba93",
    0x01: "5b3cd846732e9ea0c5180fd4dc1800ad79658724a63ea60e1bcfb499289e882f",
}
BATCH_LAYER4_PROOF_SHA256 = {
    0x00: "ec2d0ea60fc45da9e7e18e3cb438c17830bf748eaaeb6d7f8d4e10201a36b62a",
    0x01: "95122828632bfed0615fb98dcf1597f93db75c6f0679ab3b88f91c83f362056f",
}
BATCH_K3_ROWS = 8  # column-windows of layer 3's densest commit group held against the plain K3
BATCH_K5_SLICE = 1 << 16  # scalars of each of layer 3's K5 calls held against the plain version


def wrapper(key: str):
    mod, name = KERNELS[key][:2]
    return getattr(importlib.import_module(f"scroll_prover_tpu_torch.ops.{mod}"), name)


def kernel_name(key: str) -> str:
    return f"{key} {'/'.join(KERNELS[key][2])}"


def reset_counts(fn) -> None:
    fn.launches = 0
    if hasattr(fn, "by_mode"):
        fn.by_mode = dict.fromkeys(fn.by_mode, 0)


_T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


# the MSM's host step after the device work, wrapped by host_step_hook():
# the host fold of a bucket table (the reduction before K4 folded on the
# card) and the affine conversion of K4's projective points; calls and
# seconds of each, taken at every clock()
HOST_STEPS = ("_host_fold_mont", "_affine_columns")
HOST = {name: [0, 0.0] for name in HOST_STEPS}
_HOST_AT_CLOCK = {name: [0, 0.0] for name in HOST_STEPS}
HOST_ORACLE = {}  # the unwrapped functions, for the checks' own calls


def host_step_hook() -> None:
    """Wrap each of HOST_STEPS that msm_tile defines so that a call adds to
    HOST; the checks call HOST_ORACLE's originals, which count nothing."""
    from scroll_prover_tpu_torch.ops import msm_tile as mt

    for name in HOST_STEPS:
        orig = getattr(mt, name, None)
        if orig is None:
            continue

        def timed(*a, _orig=orig, _name=name):
            t0 = time.perf_counter()
            out = _orig(*a)
            HOST[_name][0] += 1
            HOST[_name][1] += time.perf_counter() - t0
            return out

        HOST_ORACLE[name] = orig
        setattr(mt, name, timed)


def host_since(mark: dict) -> dict:
    """{step: [calls, seconds]} since `mark` (a copy of HOST)."""
    return {name: [HOST[name][0] - mark[name][0], HOST[name][1] - mark[name][1]] for name in HOST_STEPS}


def host_mark() -> dict:
    return {name: list(v) for name, v in HOST.items()}


def clock(what: str) -> None:
    """The script's own seconds so far, at a phase's end, and the MSM's
    host steps since the clock before."""
    global _HOST_AT_CLOCK
    log(f"clock: {what} at {time.perf_counter() - _T_START:.1f} s; MSM host steps since the clock before "
        f"[calls, seconds]: {json.dumps(host_since(_HOST_AT_CLOCK))}")
    _HOST_AT_CLOCK = host_mark()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    leave(1)


def leave(code: int) -> None:
    """Exit without the interpreter's teardown: after phases 6 and 7 the
    host holds tens of GiB of Python objects, and tearing them down took
    2-4 minutes on the card's host."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, n: int):
    """Mean CUDA-event ms of n calls of fn, and the last output."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        out = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n, out


def time_turns(kernel, plain, reps: int):
    """CUDA-event times in ms, in turns plain, kernel, kernel, plain (after a
    warm-up of each). Returns (kernel_ms, plain_ms, kernel_out, plain_out)."""
    k_out = kernel()
    p_out = plain()
    torch.cuda.synchronize()
    p1, _ = event_ms(plain, 1)
    k1, _ = event_ms(kernel, reps)
    k2, _ = event_ms(kernel, reps)
    p2, _ = event_ms(plain, 1)
    return (k1 + k2) / 2, (p1 + p2) / 2, k_out, p_out


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_field(f, n: int, gen, dev):
    """n canonical elements as (n, 16) int32 limbs (top limb below p's)."""
    x = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev, dtype=torch.int32)
    x[:, 15] %= int(f.p_limbs[15])
    return x


def bound(bytes_moved: float, muls):
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, float(muls) / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _distinct_bytes(x) -> int:
    """Bytes of the distinct elements a tensor view holds (a dimension with
    stride 0, a broadcast, counts once)."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride:
            n *= size
    return 4 * n


def k1_key(mode: int) -> str:
    """K1 for the product modes of csrc/mont_mul.cu, K1as for add/sub/neg."""
    from scroll_prover_tpu_torch.ops import field_ops as fo

    return "K1" if mode in (fo.MUL, fo.MUL_ADD, fo.MUL_SUB) else "K1as"


def work(key: str, *args):
    """(bytes, 32-bit multiplies) the kernel `key` must spend on the wrapper
    arguments `args`: each input read once, each output written once; the
    MSM kernels count the point adds these digits need (digit 0 adds
    nothing), as a 0-d device tensor, so that work() never waits for the
    card; bound() reads it. K1 and K1as take the arguments of
    `field_ops._k1_launch` (field, mode, operands), which every
    mode passes through; an operand given twice (a squaring, z*z - z) is
    read once. The product modes count one product per element, add, sub
    and neg none: they are bytes-bound."""
    if key in ("K1", "K1as"):
        _f, mode, ops = args
        n = torch.broadcast_shapes(*(x.shape for x in ops)).numel() // 16
        distinct = {(x.data_ptr(), tuple(x.shape), x.stride()): x for x in ops}.values()
        return (sum(_distinct_bytes(x) for x in distinct) + 64 * n,
                MULS_PER_MONT * n if k1_key(mode) == "K1" else 0)
    if key == "K2":  # a pass: rows in and out once, each table once; k/2 products per
        # element in the stages plus one per table product it applies
        x, tw, k, _stride, twmid, pre, post, n_inv, _last, _inplace = args
        tables = [t for t in (tw, twmid, pre, post, n_inv) if t is not None]
        products = k / 2 + sum(t is not None for t in (twmid, pre, post, n_inv))
        return 8 * x.numel() + sum(4 * t.numel() for t in tables), \
            MULS_PER_MONT * (x.numel() // 16) * products
    if key == "K3":  # output: the (CW, S, 32) per-slot buckets, 96 B each
        from scroll_prover_tpu_torch.ops.msm_tile import _slots

        pts, digs, signs, B = args
        CW, n = digs.shape
        live = torch.count_nonzero(digs)
        out_bytes = CW * _slots(n) * (B - 1) * 96
        return 4 * (pts.numel() + digs.numel() + signs.numel()) + out_bytes, live * 11 * MULS_PER_MONT
    if key == "K4":  # the adds the function needs, not the kernel's own: the slot tree's
        # S - 1 per bucket, sum_b b * B_b by running sums (R += B_b, T += R from b = NB
        # down: 2 (NB - 1) a window, not the scans' 2 x 129), and the fold's W - 1 adds and
        # (W - 1) c doublings (8 products each) a column; out: a point per column
        from scroll_prover_tpu_torch.ops.msm_tile import MSM_C, _wb

        (tbl,) = args
        CW, S, NB = tbl.shape[:3]
        W = _wb(MSM_C)[0]
        C = CW // W
        adds = CW * (S - 1) * NB + CW * 2 * (NB - 1) + C * (W - 1)
        return 4 * tbl.numel() + C * 96, (adds * 12 + C * (W - 1) * MSM_C * 8) * MULS_PER_MONT
    if key == "K5":
        table, digs = args
        nz = torch.count_nonzero(digs)
        return 4 * (table.numel() + digs.numel()) + 3 * 64 * digs.shape[1], nz * 11 * MULS_PER_MONT
    if key == "K6":
        px, py, digs, signs = args
        live = torch.count_nonzero(digs)
        out_bytes = digs.shape[0] * 9 * 3 * 64 * px[0, 0].numel()
        return 4 * (px.numel() + py.numel() + digs.numel() + signs.numel()) + out_bytes, \
            live * 11 * MULS_PER_MONT
    x, tw, s = args  # K7, K8: the twiddles a level reads are n >> (s + 1) distinct rows
    n = x.shape[1]
    per = 1 if key == "K7" else 2  # products per element pair / quad: n/2 or n
    return 2 * 64 * n + 64 * (n >> (s + 1)), MULS_PER_MONT * (n // 2) * per


def check_k1(dev, gen, rows):
    """Phase 2 for K1: every mode (the products a*b, a*b + c, a*b - c as
    K1; a + b, a - b, -a as K1as) against its plain version, in every
    operand layout the main path gives it, each at 2^23 Fr elements (the
    extended quotient's column length): row-major (timed, in turns with the
    plain version), a limb-major plane seen as (N, 16) (element stride 1),
    views with no single element stride, which the wrapper copies (every
    operand at once, as the curve adds' slices are), a stride-0 scalar (a
    challenge broadcast over a column; in the a place for the fused modes,
    as axpy has it); and Fq at 2^20 (the curve arithmetic). Each mode's row in `rows[key]["modes"]`; the
    K1 row's headline is "mul", K1as's "add"."""
    from scroll_prover_tpu_torch.fields.limbs import FQ_LIMB, FR_LIMB
    from scroll_prover_tpu_torch.ops import field_ops as fo

    def call(mode, f, x, y, z):
        """(kernel closure, plain closure, wrapper key) of one mode."""
        if mode in ("mul", "mul_add", "mul_sub"):
            c = None if mode == "mul" else z
            return (lambda: fo.mont_mul_k1(f, x, y, c=c, sub=mode == "mul_sub"),
                    lambda: fo._mont_mul_plain(f, x, y) if c is None
                    else fo._mont_mul_add_plain(f, x, y, c, sub=mode == "mul_sub"), "K1")
        m = fo.MODE_NAMES.index(mode)
        plain = {"add": fo._add_mod_plain, "sub": fo._sub_mod_plain}.get(mode)
        if mode == "neg":
            return lambda: fo.add_sub_k1(f, m, x), lambda: fo._neg_mod_plain(f, x), "K1as"
        return lambda: fo.add_sub_k1(f, m, x, y), lambda: plain(f, x, y), "K1as"

    n, nq = 1 << 23, 1 << 20
    a, b, c = (rand_field(FR_LIMB, n, gen, dev) for _ in range(3))
    a[:3] = 0  # -0 = 0
    b[1] = 0
    b[3] = a[3]  # a - b = 0
    b[4] = fo._neg_mod_plain(FR_LIMB, a[4])  # a + b = p = 0
    a[5] = fo._const(FR_LIMB, "p", dev)
    a[5, 0] -= 1  # p - 1
    s = rand_field(FR_LIMB, 1, gen, dev)[0]  # (16,)
    lm = rand_field(FR_LIMB, n, gen, dev).T.contiguous()  # (16, 2^23) plane
    lm_view = lm.T  # (2^23, 16), element stride 1
    aq, bq, cq = (rand_field(FQ_LIMB, nq, gen, dev) for _ in range(3))
    for key in ("K1", "K1as"):
        rows[key] = {"modes": {}}
    for mode in fo.MODE_NAMES:
        kern, plain, key = call(mode, FR_LIMB, a, b, c)
        k_ms, p_ms, ko, po = time_turns(kern, plain, 20)
        errs = {"row-major 2^23": max_abs_err(ko, po)}
        del ko, po
        fused = mode in ("mul_add", "mul_sub")
        cases = {
            "limb-major view 2^23": (FR_LIMB, lm_view, b, c),
            "copied views 2^22": (FR_LIMB, *(x.view(-1, 4, 16)[:, :2] for x in (a, b, c))),
            "stride-0 scalar 2^23": (FR_LIMB, s, a, c) if fused else (FR_LIMB, a, s, c),
            "Fq 2^20": (FQ_LIMB, aq, bq, cq),
        }
        for name, (f, x, y, z) in cases.items():
            kern_l, plain_l, _ = call(mode, f, x, y, z)
            errs[name] = max_abs_err(kern_l(), plain_l())
        ops = {"mul_add": (a, b, c), "mul_sub": (a, b, c), "neg": (a,)}.get(mode, (a, b))
        bd = bound(*work(key, FR_LIMB, fo.MODE_NAMES.index(mode), ops))
        err = max(errs.values())
        rows[key]["modes"][mode] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bd[0], "bound_by": bd[1],
                                    "max_abs_err": err}
        log(f"{key} {mode}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms at 2^23, bound {bd[0]:.4f} ms "
            f"({bd[1]}); max_abs_err by layout {json.dumps(errs)}")
        if err != 0:
            fail(f"{key} mode {mode} disagrees with its plain version")
    # the card's own streaming rate at K1as's byte counts: int32 torch ops
    # moving the same bytes (neg: one read, one write; add: two reads, one)
    torch.neg(a), torch.add(a, b)
    neg_ms, _ = event_ms(lambda: torch.neg(a), 20)
    add_ms, _ = event_ms(lambda: torch.add(a, b), 20)
    log(f"same bytes as K1as at 2^23 rows, torch int32 ops: neg {neg_ms:.4f} ms, add {add_ms:.4f} ms")
    for key, head in (("K1", "mul"), ("K1as", "add")):
        modes = rows[key]["modes"]
        rows[key].update({k: v for k, v in modes[head].items()})
        rows[key]["max_abs_err"] = max(m["max_abs_err"] for m in modes.values())


def check_kernels(dev, gen):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    from scroll_prover_tpu_torch.curves.bn254_curve import g1_generator, host_msm_jac
    from scroll_prover_tpu_torch.fields.limbs import FQ_LIMB, FR_LIMB, limbs_from_torch, limbs_to_ints
    from scroll_prover_tpu_torch.ops import field_ops as fo
    from scroll_prover_tpu_torch.ops import fixed_base as fb
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.ops import ntt_tile as nt

    rows = {}

    def record(key, k_ms, p_ms, err, *args):
        b = bound(*work(key, *args))
        rows[key] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1]}
        log(f"{kernel_name(key)}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}), max_abs_err {err}")
        if err != 0:
            fail(f"{key} disagrees with its plain version")

    check_k1(dev, gen, rows)

    # K2: the chunk's densest pass, the first of a 4-column coset transform
    # at k = 20 (rows of 256 at stride 4096, a per-position scale on load,
    # the four-step twiddles after the row NTTs)
    tw, twmid = nt.TiledDomain(20, dev)._tables[False][0]
    x = rand_field(FR_LIMB, 4 << 20, gen, dev).reshape(4, 1 << 20, 16)
    pre = rand_field(FR_LIMB, 1 << 20, gen, dev)
    k2_args = (tw, 8, 4096, twmid, pre, None, None, False, False)
    k_ms, p_ms, ko, po = time_turns(
        lambda: nt._ntt_pass_k2(x, *k2_args), lambda: nt._ntt_pass_plain(x, *k2_args), 10)
    record("K2", k_ms, p_ms, max_abs_err(ko, po), x, *k2_args)
    del x, pre, tw, twmid, ko, po
    k2_control(dev, gen, "phase 2")
    k2_tile_sweep(dev, gen)

    # K7 / K8 at every level of the staged 2^20 NTT; the row's headline is
    # level 0 (earlier runs timed only it and the last level)
    for key, lv in k78_levels(dev, gen).items():
        rows[key] = k78_row(lv)
    k78_tile_sweep(dev, gen)
    k78_small_planes(dev, gen)

    # points for the MSMs: K5 on random scalars (K5 itself is checked below)
    npts, cols = 1 << 16, 2
    s_pts = rand_field(FR_LIMB, npts, gen, dev)
    pts = fb.fixed_base_mul_dev(g1_generator(), s_pts)
    scal = [rand_field(FR_LIMB, npts, gen, dev) for _ in range(cols)]
    scal[0][:7] = 0  # zero scalars land in no bucket
    W, B = mt._wb(mt.MSM_C)
    ptw = mt._msm_pack_points(pts)
    prepped = [mt._msm_prep_digits(s, mt.MSM_C) for s in scal]
    digs = torch.cat([d for d, _ in prepped])
    signs = torch.cat([s for _, s in prepped])

    # K3: the raw per-slot tables, (86, 64, 32, 3, 8)
    k_ms, p_ms, k3o, p3o = time_turns(
        lambda: mt._accum_k3(ptw, digs, signs, B),
        lambda: mt._accum_v2_plain(ptw, digs, signs, B), 3)
    record("K3", k_ms, p_ms, max_abs_err(k3o, p3o), ptw, digs, signs, B)
    # K4 on K3's output (2 columns), down to a point per column in 2 launches
    k4 = k4_check(k3o, "phase 2")
    record("K4", k4["ms"], k4["plain_ms"], k4["max_abs_err"], k3o)
    rows["K4"]["reductions"] = {"phase 2": k4}
    del k3o, p3o

    # K6 on the same points and columns, as its raw per-lane table
    v1 = mt._v1_prep(pts, scal)
    px4, py4 = v1[0], v1[1]
    d4, s4 = (t.reshape(-1, *t.shape[2:]) for t in v1[2:])  # (C * W4, tiles, 8, 128)
    k_ms, p_ms, ko, po = time_turns(
        lambda: mt._msm_buckets_lanes_k6(px4, py4, d4, s4),
        lambda: mt._msm_buckets_lanes_plain(px4, py4, d4, s4), 3)
    record("K6", k_ms, p_ms, max_abs_err(ko, po), px4, py4, d4, s4)
    del v1, px4, py4, d4, s4, ko, po

    # the whole MSMs against host Pippenger at 2^10 points
    m = 1 << 10
    host_pts_flat = limbs_to_ints(limbs_from_torch(fo.from_mont(FQ_LIMB, pts[:m].reshape(2 * m, 16))))
    host_pts = list(zip(host_pts_flat[0::2], host_pts_flat[1::2]))
    for s in scal:
        want = host_msm_jac(host_pts, limbs_to_ints(limbs_from_torch(s[:m])))
        if mt.msm_v2_host(pts[:m], s[:m]) != want:
            fail("K3/K4 MSM disagrees with host Pippenger")
        if mt.msm_tile_host(pts[:m], s[:m]) != want:
            fail("K6 MSM disagrees with host Pippenger")
    log("K3/K4 and K6 MSMs at 2^10 points == host_msm_jac")

    # K5 at 2^16 scalars
    table = fb._table_for(g1_generator(), dev)
    sc = rand_field(FR_LIMB, npts, gen, dev)
    sc[:3] = 0
    d5 = fb._digits(sc)
    k_ms, p_ms, ko, po = time_turns(
        lambda: torch.stack(list(fb._accumulate_k5(table, d5))),
        lambda: torch.stack(list(fb._accumulate_plain(table, d5))), 5)
    record("K5", k_ms, p_ms, max_abs_err(ko, po), table, d5)
    # K5 alone at the main path's shape: generate_fast(20) gives it 2^20
    # scalars per launch (the profiled prove launches it never)
    d20 = fb._digits(rand_field(FR_LIMB, 1 << 20, gen, dev))
    fb._accumulate_k5(table, d20)
    k_ms, _ = event_ms(lambda: fb._accumulate_k5(table, d20), 3)
    b = bound(*work("K5", table, d20))
    log(f"K5 at 2^20 scalars (main-path shape): {k_ms:.4f} ms per launch, bound {b[0]:.4f} ms ({b[1]})")
    return rows


def smi_state() -> str:
    """nvidia-smi's SM clock (now and its maximum), temperature and power
    draw, read-only."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def k2_control(dev, gen, where: str) -> float:
    """K2 at phase 2's pass (4 x 2^20, k = 8, stride 4096, scale + twmid;
    random values), 20 launches back to back by CUDA events: the same work
    wherever it runs, so that a change in the card's state shows apart from
    the passes' own times. Logged beside nvidia-smi's clock, temperature
    and power draw read just after."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import ntt_tile as nt

    tw, twmid = nt.TiledDomain(20, dev)._tables[False][0]
    x = rand_field(FR_LIMB, 4 << 20, gen, dev).reshape(4, 1 << 20, 16)
    args = (tw, 8, 4096, twmid, rand_field(FR_LIMB, 1 << 20, gen, dev), None, None, False, False)
    nt._ntt_pass_k2(x, *args)
    ms, _ = event_ms(lambda: nt._ntt_pass_k2(x, *args), 20)
    log(f"K2 control at {where} (phase 2's pass, 20 launches): {ms:.4f} ms per launch; "
        f"card now (SM clock, max, degrees C, power): {smi_state()}")
    return ms


def k2_tile_sweep(dev, gen) -> None:
    """Phase 2, K2's tile size: the chunk's single-column passes and its
    4-column passes (the first pass of a coset transform, rows of 256 at
    stride 4096 with twmid and pre; the last, rows of 16) at 2^lg_tile
    elements per block, lg_tile 8 to 11 (the engine's: 9 at k = 8, 8 at
    k = 4), each held exactly against the engine's tile, beside the
    runtime's resident blocks per SM for that tile and the waves of blocks
    they make."""
    import ctypes

    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import cuda_lib
    from scroll_prover_tpu_torch.ops import ntt_tile as nt

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    td = nt.TiledDomain(20, dev)
    (tw0, twmid0), _, (tw2, _) = td._tables[False]
    pre = rand_field(FR_LIMB, 1 << 20, gen, dev)
    occ = {}
    for lg in (8, 9, 10, 11):
        buf = (ctypes.c_int * 4)()
        cuda_lib.check(cuda_lib.lib("ntt").spt_ntt_pass_occupancy(lg, ctypes.addressof(buf)), "K2 occupancy")
        occ[lg] = tuple(buf)
        log(f"K2 tile 2^{lg}: {buf[0]} resident blocks per SM ({buf[2]} threads, {buf[1]} registers, "
            f"{buf[3] // 1024} KiB shared each) on {sms} SMs")
    for cols in (1, 4):
        x = rand_field(FR_LIMB, cols << 20, gen, dev).reshape(cols, 1 << 20, 16)
        for name, args in (("k = 8, stride 4096, twmid+pre", (tw0, 8, 4096, twmid0, pre, None, None, False, False)),
                           ("k = 4, stride 1, last", (tw2, 4, 1, None, None, None, None, True, False))):
            want = nt._ntt_pass_k2(x, *args)
            b = bound(*work("K2", x, *args))
            for lg in (8, 9, 10, 11):
                err = max_abs_err(nt._ntt_pass_k2(x, *args, lg_tile=lg), want)
                ms, _ = event_ms(lambda: nt._ntt_pass_k2(x, *args, lg_tile=lg), 20)
                blocks = cols << (20 - lg)
                log(f"K2 tile sweep ({cols}, 2^20) {name}, tile 2^{lg}: {ms:.4f} ms by CUDA events, "
                    f"{100 * b[0] / ms:.1f}% of bound {b[0]:.4f} ms; {blocks} blocks, "
                    f"{blocks / (occ[lg][0] * sms):.2f} waves; vs the engine's tile: max_abs_err {err}")
                if err != 0:
                    fail("K2's output depends on its tile size")
        del x, want


K78_K = 20  # K7/K8 are held and timed at every level of a 2^20 plane
K78_TILES = (7, 8, 9, 10)  # lg of the elements per tile in K7/K8's tile sweep


def k78_tables(nf, tw):
    """The K7/K8 wrappers' twiddle argument made from a (16, n/2) table:
    its per-level tables (`level_tables`); a tree from before them (the
    parent, run in the same call for a comparison) takes the table itself."""
    level_tables = getattr(nf, "level_tables", None)
    return level_tables(tw) if level_tables else tw


def k78_levels(dev, gen):
    """Phase 2 for K7 and K8: every level s of a 2^20 plane (K7 s = 0..19;
    K8 s = 0..18, of which FastDomain's radix 4 launches the even s), each
    held exactly against its plain version (fatal on any difference) and
    timed by CUDA events in turns (20 launches), beside work()'s bound, the
    share of it and the stride regime (the partners' distance, half for
    K7 and q for K8, below 32 elements or not). Then the summed time
    against the summed bound of the launches one FastDomain(20).ntt makes:
    K7 at every s (radix 2), K8 at the even s (radix 4). Returns {key:
    [one dict per level]}."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import ntt_fast as nf

    k = K78_K
    x = rand_field(FR_LIMB, 1 << k, gen, dev).T.contiguous()  # (16, 2^20)
    tw = k78_tables(nf, rand_field(FR_LIMB, 1 << (k - 1), gen, dev).T.contiguous())
    out = {}
    for key, kern, plain, lv in (("K7", nf._butterfly_k7, nf._butterfly_plain, 1),
                                 ("K8", nf._butterfly4_k8, nf._butterfly4_plain, 2)):
        levels = []
        for s in range(k - lv + 1):
            k_ms, p_ms, ko, po = time_turns(lambda: kern(x, tw, s), lambda: plain(x, tw, s), 20)
            err = max_abs_err(ko, po)
            b = bound(*work(key, x, tw, s))
            dist = (1 << k) >> (s + lv)
            levels.append({"s": s, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0], "bound_by": b[1],
                           "share": b[0] / k_ms, "partners": dist, "max_abs_err": err})
            log(f"{key} level s = {s} ({'half' if lv == 1 else 'q'} = {dist}, "
                f"{'below' if dist < 32 else 'at least'} 32): kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, "
                f"bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / k_ms:.1f}% of bound, max_abs_err {err}")
            if err != 0:
                fail(f"{key} at level {s} disagrees with its plain version")
        path = levels if lv == 1 else levels[::2]
        t, b = sum(v["ms"] for v in path), sum(v["bound_ms"] for v in path)
        log(f"{key}: the {len(path)} launches of one FastDomain({k}).ntt at radix {2 * lv}: "
            f"{t:.4f} ms against a summed bound of {b:.4f} ms ({100 * b / t:.1f}%)")
        out[key] = levels
    return out


def k78_row(levels) -> dict:
    """The kernels-line row of K7 or K8 from k78_levels: level 0 as the
    headline (as earlier runs had it), the worst level's share, the
    FastDomain(20) sums and every level's figures."""
    l0, worst = levels[0], min(levels, key=lambda v: v["share"])
    path = levels if len(levels) == K78_K else levels[::2]
    return {
        "ms": l0["ms"], "plain_ms": l0["plain_ms"], "bound_ms": l0["bound_ms"], "bound_by": l0["bound_by"],
        "max_abs_err": max(v["max_abs_err"] for v in levels),
        "worst_level": worst["s"], "worst_share": worst["share"],
        "fast_domain_ms": sum(v["ms"] for v in path), "fast_domain_bound_ms": sum(v["bound_ms"] for v in path),
        "levels": [{key: v[key] for key in ("s", "ms", "bound_ms", "share")} for v in levels],
    }


def k78_tile_sweep(dev, gen) -> None:
    """Phase 2, K7 and K8's tile size: every level of a 2^20 plane at
    2^lg elements per tile for lg in K78_TILES, each held exactly against
    the wrapper's default tile, with the runtime's resident blocks per SM
    for each tile."""
    import ctypes

    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import cuda_lib
    from scroll_prover_tpu_torch.ops import ntt_fast as nf

    k = K78_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = rand_field(FR_LIMB, 1 << k, gen, dev).T.contiguous()
    tw = nf.level_tables(rand_field(FR_LIMB, 1 << (k - 1), gen, dev).T.contiguous())
    for key, kern, lv in (("K7", nf._butterfly_k7, 1), ("K8", nf._butterfly4_k8, 2)):
        for lg in K78_TILES:
            buf = (ctypes.c_int * 4)()
            cuda_lib.check(cuda_lib.lib("ntt_fast").spt_butterfly_occupancy(1 << lv, lg, ctypes.addressof(buf)),
                           f"{key} occupancy")
            log(f"{key} tile 2^{lg}: {buf[0]} resident blocks per SM ({buf[2]} threads, {buf[1]} registers, "
                f"{buf[3] // 1024} KiB shared each) on {sms} SMs; {1 << (k - lg)} tiles")
        for s in range(k - lv + 1):
            want = kern(x, tw, s)
            b = bound(*work(key, x, tw, s))[0]
            cells = []
            for lg in K78_TILES:
                err = max_abs_err(kern(x, tw, s, lg_tile=lg), want)
                if err != 0:
                    fail(f"{key}'s output at level {s} depends on its tile size")
                ms, _ = event_ms(lambda: kern(x, tw, s, lg_tile=lg), 20)
                cells.append(f"2^{lg} {ms:.4f} ms {100 * b / ms:.1f}%")
            log(f"{key} tile sweep s = {s}: " + "; ".join(cells) + " (each exact against the default tile)")
        del want


def k78_small_planes(dev, gen) -> int:
    """Phase 2, K7 and K8 on small planes, 2^1 to 2^12 (the tile capped at
    the plane, the two-element plane moved a limb at a time): every level at
    every tile size the wrappers take, each held exactly against the plain
    version; then FastDomain(k) at both radixes against its plain path on
    the CPU. Returns the number of kernel launches held."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import ntt_fast as nf

    held = 0
    for k in range(1, 13):
        x = rand_field(FR_LIMB, 1 << k, gen, dev).T.contiguous()
        tw = nf.level_tables(rand_field(FR_LIMB, 1 << (k - 1), gen, dev).T.contiguous())
        for key, kern, plain, lv in (("K7", nf._butterfly_k7, nf._butterfly_plain, 1),
                                     ("K8", nf._butterfly4_k8, nf._butterfly4_plain, 2)):
            for s in range(k - lv + 1):
                want = plain(x, tw, s)
                for lg in range(1, nf.LG_TILE_MAX + 1):
                    try:
                        nf._lg_tile(k, s, lv, lg)
                    except ValueError:
                        continue
                    if max_abs_err(kern(x, tw, s, lg_tile=lg), want) != 0:
                        fail(f"{key} at level {s} of 2^{k}, tile 2^{lg}, disagrees with its plain version")
                    held += 1
        xr = rand_field(FR_LIMB, 1 << k, gen, dev)
        for radix in (2, 4):
            got = nf.FastDomain(k, radix=radix, device=dev).ntt(xr)
            if not torch.equal(got.cpu(), nf.FastDomain(k, radix=radix, device="cpu").ntt(xr.cpu())):
                fail(f"FastDomain({k}, radix={radix}) on the card != its plain path")
    log(f"K7/K8 on planes of 2^1 to 2^12: {held} launches (every level, every tile size) == plain; "
        f"FastDomain(1..12) at radix 2 and 4 == its plain path")
    return held


def fast_domain_levels(nf, fd, y):
    """The butterfly launches of FastDomain.ntt on its limb-major plane y,
    as `ntt` makes them (radix 4: K8 per level pair, K7 for an odd k's last
    level)."""
    s = 0
    while s < fd.k:
        if fd.radix == 4 and s + 1 < fd.k:
            y = nf.butterfly4_t(y, fd.tw, s)
            s += 2
        else:
            y = nf.butterfly_t(y, fd.tw, s)
            s += 1
    return y


def fast_domain_times(dev, gen) -> dict:
    """FastDomain(20).ntt at radix 2 and 4 beside the tiled NTT (K2), each
    held exactly against EvaluationDomain(20).ntt: device ms by CUDA events
    over 10 calls back to back, of the whole call and of its three parts
    (the entry transpose to limb-major, the K7/K8 launches, the final
    bit-reversal gather back to (n, 16)); the parts' own composition is held
    to the same output. Returns {name: ms}."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import ntt_fast as nf
    from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain

    k = K78_K
    x = rand_field(FR_LIMB, 1 << k, gen, dev)
    dom = EvaluationDomain(k)
    want = dom.ntt(x)  # builds the device tables
    ms = {"tiled ntt (K2)": event_ms(lambda: dom.ntt(x), 10)[0]}
    for radix in (2, 4):
        fd = nf.FastDomain(k, radix=radix, device=dev)
        if not torch.equal(fd.ntt(x), want):
            fail(f"FastDomain({k}, radix={radix}).ntt != EvaluationDomain({k}).ntt")
        tag = f"FastDomain radix {radix}"
        ms[tag], _ = event_ms(lambda: fd.ntt(x), 10)
        ms[f"{tag}: entry transpose"], y = event_ms(lambda: x.T.contiguous(), 10)
        ms[f"{tag}: {'K7' if radix == 2 else 'K8'} launches"], z = event_ms(lambda: fast_domain_levels(nf, fd, y), 10)
        ms[f"{tag}: final gather"], got = event_ms(lambda: z.index_select(1, fd.br).T.contiguous(), 10)
        if not torch.equal(got, want):
            fail(f"FastDomain({k}, radix={radix})'s parts != EvaluationDomain({k}).ntt")
    log(f"FastDomain({k}) radix 2 and radix 4 == tiled NTT, exactly; device ms by CUDA events "
        f"(10 calls each): {json.dumps(ms)}")
    return ms


def main_path(dev):
    """Phase 3: generate_fast(20), keygen, prove, verify of BenchCircuit.
    Returns the phase seconds, a closure that proves again, the proof, the
    SRS and a closure that verifies a proof."""
    from scroll_prover_tpu_torch.integration.bench_circuit import BenchCircuit
    from scroll_prover_tpu_torch.proof_system.kzg import SRS
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify

    k, instance = 20, [[7]]
    secs = {}

    def phase(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"main path {name}: {secs[name]:.2f} s")
        return out

    circ = BenchCircuit(4096)
    srs = phase("srs_generate_fast", lambda: SRS.generate_fast(k, device=dev))
    pk, vk = phase("keygen", lambda: keygen(srs, k, circ, instance))
    proof = phase("prove", lambda: prove(srs, pk, circ, instance, seed=b"chip-smoke"))
    ok = phase("verify", lambda: verify(srs, vk, instance, proof))
    if not ok:
        fail("k=20 proof did not verify")
    bad = bytearray(proof)
    bad[100] ^= 1
    if verify(srs, vk, instance, bytes(bad)):
        fail("a tampered k=20 proof verified")
    log(f"main path proof: {len(proof)} bytes, verify True, tampered proof rejected")
    digest = hashlib.sha256(proof).hexdigest()
    log(f"main path proof sha256: {digest} (pinned {PROOF_SHA256})")
    if digest != PROOF_SHA256:
        fail("the k=20 proof's bytes differ from the pinned proof")
    return (secs, lambda: prove(srs, pk, circ, instance, seed=b"chip-smoke"), proof, srs,
            lambda p: verify(srs, vk, instance, p))


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def alt_engines(dev, gen, srs):
    """Phase 4: the FastDomain NTT (K7/K8), the v1 MSM (K6) and the batched
    Poseidon at k = 20 on the main path's SRS, each held exactly against
    its counterpart on K1-K5 or the host; wall ms of each beside it.
    Returns the MSM columns."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.hashes.poseidon import poseidon_fr
    from scroll_prover_tpu_torch.ops import ec
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.ops.poseidon_dev import PoseidonDev

    k = 20
    n = 1 << k
    ms = {}

    # NTT: 2^20 Montgomery column, tiled four-step (K2) vs staged (K7/K8),
    # device time of each and of FastDomain's parts
    fast_domain_times(dev, gen)

    # MSM: 4 columns of 2^20 scalars over the SRS monomial basis, one short
    # (2^20 - 4096) and one holding zero scalars; v1 (K6) vs v2 (K3/K4)
    base = srs.dev_powers()
    cols = [rand_field(FR_LIMB, n, gen, dev) for _ in range(4)]
    cols[1] = cols[1][: n - 4096]
    cols[2][: 1 << 16] = 0
    cols[2][::7] = 0
    ms["msm_v2_host_batch x4 (K3/K4)"], want = wall_ms(lambda: mt.msm_v2_host_batch(base, cols))
    ms["msm_tile_host_batch x4 (K6)"], got = wall_ms(lambda: mt.msm_tile_host_batch(base, cols))
    if got != want or None in got:
        fail("msm_tile_host_batch != msm_v2_host_batch over 4 columns of 2^20")
    log("msm_tile_host_batch == msm_v2_host_batch on 4 columns of 2^20 scalars")

    # msm_tile (device fold) vs msm_tile_host at 2^16 points
    m = 1 << 16
    ms["msm_tile 2^16 (K6, device fold)"], acc = wall_ms(lambda: mt.msm_tile(base[:m], cols[0][:m]))
    ms["msm_tile_host 2^16 (K6, host fold)"], host = wall_ms(lambda: mt.msm_tile_host(base[:m], cols[0][:m]))
    if host is None or ec.decode_point(acc) != host:
        fail("msm_tile decoded != msm_tile_host at 2^16 points")
    log("msm_tile (decoded) == msm_tile_host at 2^16 points")

    # Poseidon: 2^16 rows on the card vs host Poseidon on 64 sampled rows
    rows = 1 << 16
    rng = torch.Generator().manual_seed(4)
    a = [int(v) for v in torch.randint(0, 1 << 62, (rows,), generator=rng)]
    b = [int(v) * 3 + 1 for v in torch.randint(0, 1 << 62, (rows,), generator=rng)]
    a[0] = FR_LIMB.modulus - 1
    pd = PoseidonDev(device=dev)
    ms["PoseidonDev.hash2_batch 2^16 (K1)"], out = wall_ms(lambda: pd.hash2_batch(a, b, domain=2))
    pick = [0] + [int(i) for i in torch.randint(1, rows, (63,), generator=rng)]
    t0 = time.perf_counter()
    host = [poseidon_fr.hash2(a[i], b[i], domain=2) for i in pick]
    ms["host poseidon_fr x64"] = (time.perf_counter() - t0) * 1e3
    if [out[i] for i in pick] != host:
        fail("PoseidonDev.hash2_batch != host poseidon_fr")
    log("PoseidonDev.hash2_batch over 2^16 rows == host poseidon_fr on 64 sampled rows")
    for name, t in ms.items():
        log(f"phase 4 wall: {name}: {t:.1f} ms")
    return cols


def v1_breakdown(base, cols) -> int:
    """Run after phase 4's launch counts are read. Holds K6 against its
    plain version at the shape phase 4 gave it (the 4 columns' raw per-lane
    table, 256 column-windows x 1024 tiles), and shows where the v1 batch
    spends its time: digit prep, K6 (also by CUDA events, beside its bound
    here), the plain-torch lane reduction, the host fold. Returns K6's
    max_abs_err."""
    from scroll_prover_tpu_torch.fields.limbs import limbs_from_torch
    from scroll_prover_tpu_torch.ops import msm_tile as mt

    ms = {}
    ms["prep"], prep = wall_ms(lambda: mt._v1_prep(base, cols))
    ms["K6"], raw = wall_ms(lambda: mt._msm_buckets_lanes_batch(*prep))
    k6_ms, _ = event_ms(lambda: mt._msm_buckets_lanes_batch(*prep), 2)
    px, py = prep[0], prep[1]
    d6, s6 = (t.reshape(-1, *t.shape[2:]) for t in prep[2:])  # (C * W4, tiles, 8, 128)
    b6 = bound(*work("K6", px, py, d6, s6))
    log(f"K6 at 2^20 points x 4 columns: {k6_ms:.3f} ms by CUDA events, bound {b6[0]:.3f} ms ({b6[1]})")
    p_ms, plain = wall_ms(lambda: mt._msm_buckets_lanes_plain(px, py, d6, s6))
    err = max_abs_err(raw.reshape(plain.shape), plain)
    log(f"K6 at phase 4's shape {tuple(d6.shape)}: raw per-lane table vs plain version "
        f"({p_ms / 1e3:.1f} s wall): max_abs_err {err}")
    if err != 0:
        fail("K6 disagrees with its plain version at phase 4's shape")
    del plain
    ms["lane reduction (plain torch)"], red = wall_ms(lambda: mt._reduce_lanes(raw))
    tbls = limbs_from_torch(red)
    ms["host fold x4"], _ = wall_ms(lambda: [mt._host_fold(t) for t in tbls])
    for name, t in ms.items():
        log(f"phase 4 v1 breakdown wall: {name}: {t:.1f} ms")
    return err


def k3_full_check(base, cols) -> int:
    """Run after phase 4's launch counts are read. Holds K3 against its
    plain version at the shape phase 4's v2 MSM gave it (the 4 columns'
    172 column-windows x 2^20 points: 256 sort tiles, runs of ~2^15
    entries), limb for limb, with its CUDA-event time beside its bound
    there. Returns K3's max_abs_err."""
    from scroll_prover_tpu_torch.ops import msm_tile as mt

    _W, B = mt._wb(mt.MSM_C)
    points, scalars = mt._pad_points_scalars(base, cols)
    pts = mt._msm_pack_points(points)
    prepped = [mt._msm_prep_digits(s, mt.MSM_C) for s in scalars]
    digs = torch.cat([d for d, _ in prepped])
    signs = torch.cat([s for _, s in prepped])
    k3_ms, raw = event_ms(lambda: mt._accum_k3(pts, digs, signs, B), 2)
    b3 = bound(*work("K3", pts, digs, signs, B))
    p_ms, plain = wall_ms(lambda: mt._accum_v2_plain(pts, digs, signs, B))
    err = max_abs_err(raw, plain)
    log(f"K3 at phase 4's shape {tuple(digs.shape)}: {k3_ms:.3f} ms by CUDA events, bound {b3[0]:.3f} ms "
        f"({b3[1]}); raw per-slot table vs plain version ({p_ms / 1e3:.1f} s wall): max_abs_err {err}")
    if err != 0:
        fail("K3 disagrees with its plain version at phase 4's shape")
    return err


def mesh_phase(dev, gen, srs, cols, prove_again, verify_proof, held_k2):
    """Phase 4b (see the module docstring): SRS.downsize at full width, then
    the mesh over NCCL at world size 1. The references (the unrouted MSM
    and NTT) and the warm-ups run first, outside the count; then the launch
    counts of MESH_PATH are taken over the path alone (generate_fast, the
    downsize, the routed MSM, the sharded NTT and the routed prove; each
    must be > 0, and K3 must equal the routed MSM calls plus the prove's
    routed commits); then K2 against its plain version at every pass the
    phase gave it that no earlier phase held.
    Returns ({key: launches}, {key: {mode: launches}}, the K2 passes held)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain
    from scroll_prover_tpu_torch.ops.ntt_tile import TiledDomain
    from scroll_prover_tpu_torch.parallel import init_process_group, make_mesh
    from scroll_prover_tpu_torch.parallel.msm_sharded import msm_tile_sharded
    from scroll_prover_tpu_torch.parallel.ntt_sharded import ShardedDomain
    from scroll_prover_tpu_torch.proof_system import kzg

    secs = {}
    passes = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"phase 4b {name}: {secs[name]:.2f} s")
        return res

    def routed_prove(mesh):
        """phase 3's prove with every commit of at least _threshold() points
        over the mesh; returns (proof, routed commits)."""
        commit_sharded = kzg._commit_sharded
        commits = [0]

        def tallied(*a):
            commits[0] += 1
            return commit_sharded(*a)

        kzg._commit_sharded = tallied
        kzg.set_commit_mesh(mesh)
        try:
            return prove_again(), commits[0]
        finally:
            kzg.set_commit_mesh(None)
            kzg._commit_sharded = commit_sharded

    def path(mesh, base, x, sdom):
        torch.cuda.reset_peak_memory_stats()
        big, gen_counts = launches_of(("K5",), lambda: step(
            f"generate_fast({DOWNSIZE_FROM})", lambda: kzg.SRS.generate_fast(DOWNSIZE_FROM, device=dev)))
        small, counts = launches_of(("K1", "K1as", "K5"), lambda: step(
            f"downsize({DOWNSIZE_TO})", lambda: big.downsize(DOWNSIZE_TO)))
        counts["K5 (generate_fast)"] = gen_counts["K5"]
        log(f"phase 4b downsize({DOWNSIZE_TO}) of generate_fast({DOWNSIZE_FROM}): launches {json.dumps(counts)}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(predicted before the first run: 10-14 s, ~117,000 K1 and ~137,000 K1as; PERF.md section 6)")
        got, msm_counts = launches_of(("K3", "K2"), lambda: step(
            "msm_tile_sharded x4", lambda: [msm_tile_sharded(mesh, base[:c.shape[0]], c) for c in cols]))
        flat, ntt_counts = launches_of(("K2", "K3"), lambda: step(
            f"ShardedDomain({srs.k}).ntt_flat", lambda: sdom.ntt_flat(x)))
        (proof, commits), prove_counts = launches_of(("K3",), lambda: step(
            "prove through the mesh", lambda: routed_prove(mesh)))
        log(f"phase 4b: the routed MSM launched {json.dumps(msm_counts)}, the sharded NTT "
            f"{json.dumps(ntt_counts)}, the prove through the mesh K3 {prove_counts['K3']} for {commits} "
            f"routed commits")
        if msm_counts != {"K3": len(cols), "K2": 0}:
            fail(f"the routed MSM of {len(cols)} columns launched {msm_counts}, not one K3 a column")
        if not ntt_counts["K2"] or ntt_counts["K3"]:
            fail(f"the sharded NTT launched {ntt_counts}: no K2, or an MSM")
        if not commits or prove_counts["K3"] != commits:
            fail(f"the prove through the mesh launched K3 {prove_counts['K3']} times for {commits} routed commits")
        return big, small, got, flat, proof, len(cols) + commits

    def run():
        # the references and the warm-ups, outside the count
        ref = srs if DOWNSIZE_TO == srs.k else kzg.SRS.generate_fast(DOWNSIZE_TO, device=dev)
        base = srs.dev_powers()
        want = step("msm_v2_host_batch x4", lambda: mt.msm_v2_host_batch(base, cols))
        x = rand_field(FR_LIMB, srs.n, gen, dev)
        tdom = TiledDomain(srs.k, dev)
        want_flat = step(f"TiledDomain({srs.k}).ntt", lambda: tdom.ntt(x))
        del tdom
        store = tempfile.mkdtemp(prefix="spt_mesh_")
        try:
            init_process_group(os.path.join(store, "store"), 0, 1, dev)
        except RuntimeError as e:
            fail(f"phase 4b: {e}")
        try:
            mesh = make_mesh(1)
            log(f"phase 4b mesh: {mesh} over {dist.get_backend()}")
            msm_tile_sharded(mesh, base, cols[0])  # NCCL sets up its communicator at the first collective
            sdom = ShardedDomain(EvaluationDomain(srs.k), mesh)
            sdom.ntt_flat(x)  # its tables, built once

            (big, small, got, flat, proof, msm_calls), launches, by_mode = counted(
                MESH_PATH, lambda: path(mesh, base, x, sdom))
            if launches["K3"] != msm_calls:
                fail(f"K3 launched {launches['K3']} times over the path, not its {msm_calls} routed MSM calls")
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)

        n = 1 << DOWNSIZE_TO
        if not torch.equal(small.dev_lagrange(), ref.dev_lagrange()):
            fail(f"downsize({DOWNSIZE_TO})'s Lagrange basis differs from generate_fast({DOWNSIZE_TO})'s")
        prefix = small.dev_powers()
        if not (torch.equal(prefix, big.dev_powers()[:n]) and torch.equal(prefix, ref.dev_powers())):
            fail(f"downsize({DOWNSIZE_TO})'s monomial basis is not the prefix of generate_fast({DOWNSIZE_FROM})'s")
        if small.g2 is not big.g2 or small.s_g2 is not big.s_g2 or small._g1_powers is not None:
            fail("downsize did not share g2 and s_g2, or decoded the host lists")
        log(f"phase 4b: downsize({DOWNSIZE_TO}) == generate_fast({DOWNSIZE_TO}) bit for bit (Lagrange and "
            f"monomial views), g2 and s_g2 shared, no host decode")
        if got != want:
            fail("msm_tile_sharded over the mesh != msm_v2_host_batch on phase 4's 4 columns")
        if not torch.equal(flat, want_flat):
            fail(f"ShardedDomain(EvaluationDomain({srs.k}), mesh).ntt_flat != TiledDomain({srs.k}).ntt")
        digest = hashlib.sha256(proof).hexdigest()
        if digest != PROOF_SHA256 or not verify_proof(proof):
            fail(f"the proof through the mesh (sha256 {digest}) is not phase 3's pinned proof or does not verify")
        log(f"phase 4b: msm_tile_sharded == msm_v2_host_batch on 4 columns of 2^{srs.k}; "
            f"ShardedDomain({srs.k}).ntt_flat == TiledDomain({srs.k}).ntt; the proof through the mesh "
            f"verifies, sha256 {digest} (pinned)")
        return launches, by_mode

    t0 = time.perf_counter()
    with hooked(("K2",), lambda _key, *a: note_k2(passes, *a)):
        launches, by_mode = run()
    secs["phase"] = time.perf_counter() - t0
    log(f"phase 4b: {secs['phase']:.1f} s; seconds {json.dumps(secs)}; path launches {json.dumps(launches)}; "
        f"K1 by mode {json.dumps(by_mode)}")
    new = {key: v for key, v in passes.items() if key not in held_k2}
    k2_pass_checks(new, dev, gen, "phase 4b")
    return launches, by_mode, frozenset(passes)


@contextlib.contextmanager
def hooked(keys, hook, after=None):
    """Wrap the wrappers of `keys` (not K1/K1as) so that each call runs
    hook(key, *args) before the kernel, and after(key) after it when given.
    A wrapper counts its launches on the function its module's name points
    to, which while wrapped is the wrapping function; on exit each count
    moves back to the wrapper itself, so `wrapper(key).launches` counts
    every launch."""
    saved = []
    for key in keys:
        mod_name, name = KERNELS[key][:2]
        mod = importlib.import_module(f"scroll_prover_tpu_torch.ops.{mod_name}")
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _key=key):
            hook(_key, *a)
            out = _orig(*a)
            if after is not None:
                after(_key)
            return out

        wrapped.launches = 0
        setattr(mod, name, wrapped)
        saved.append((mod, name, orig, wrapped))
    try:
        yield
    finally:
        for mod, name, orig, wrapped in saved:
            setattr(mod, name, orig)
            orig.launches += wrapped.launches


@contextlib.contextmanager
def bound_tally():
    """Record work() on the arguments of every kernel call (no wait for the
    card: the digit counts stay on the device); K1 and K1as are recorded,
    with their mode, at `field_ops._k1_launch`, which all their calls pass
    through. Yields {key: [(mode or None, bytes, multiplies) per call]};
    convert it with tally_bounds() once the traced work is over."""
    from scroll_prover_tpu_torch.ops import field_ops as fo

    calls = {key: [] for key in KERNELS}
    k1_launch = fo._k1_launch

    def k1_tallied(f, mode, ops):
        calls[k1_key(mode)].append((fo.MODE_NAMES[mode], *work(k1_key(mode), f, mode, ops)))
        return k1_launch(f, mode, ops)

    fo._k1_launch = k1_tallied
    try:
        with hooked([k for k in KERNELS if k not in ("K1", "K1as")],
                    lambda key, *a: calls[key].append((None, *work(key, *a)))):
            yield calls
    finally:
        fo._k1_launch = k1_launch


def tally_bounds(calls):
    """{key or (key, mode): (summed bound ms, bytes ms, operations ms)} of
    bound_tally's records."""
    groups = {}
    for key, rec in calls.items():
        for mode, by, mu in rec:
            ms = (by / HBM_BYTES_PER_S * 1e3, float(mu) / INT32_OPS_PER_S * 1e3)
            groups.setdefault(key, []).append(ms)
            if mode is not None:
                groups.setdefault((key, mode), []).append(ms)
    return {g: (sum(max(tb, to) for tb, to in ms), sum(tb for tb, _ in ms), sum(to for _, to in ms))
            for g, ms in groups.items()}


NTT_RANGE = "spt.ntt"  # the port's span around each NTT (ops/ntt_tile.py), a profiler range while tracing is on
SPAN_PREFIX = "spt."  # every span of the port (scroll_prover_tpu_torch/trace.py) as a profiler range


def range_split(prof, label: str):
    """Device work inside the `label` ranges, from the profiler's raw events:
    a kernel, copy or set is inside when it runs within one of the range's
    device-side spans (the profiler's gpu_user_annotation, from the first to
    the last device event of the work launched in the range; the port runs
    on one stream, so a span holds exactly that work). Returns (spans,
    summed span ms, {device event name: [launches, ms]} inside)."""
    evs = prof.profiler.kineto_results.events()
    on_card = [e for e in evs if e.device_type() != torch.autograd.DeviceType.CPU]
    spans = sorted((e.start_ns(), e.end_ns()) for e in on_card if e.name() == label)
    work_evs = sorted((e for e in on_card if not e.name().startswith(SPAN_PREFIX)), key=lambda e: e.start_ns())
    inside, si = {}, 0
    for e in work_evs:
        while si < len(spans) and spans[si][1] < e.start_ns():
            si += 1
        if si < len(spans) and spans[si][0] <= e.start_ns() and e.end_ns() <= spans[si][1]:
            c = inside.setdefault(e.name(), [0, 0.0])
            c[0] += 1
            c[1] += (e.end_ns() - e.start_ns()) / 1e6
    return len(spans), sum(b - a for a, b in spans) / 1e6, inside


def log_ntt_split(prof, on_dev, dev_us, tag: str) -> None:
    """The device time and launches of the largest device events, and of the
    port's kernels, inside the NTT's spans and outside them."""
    n_spans, span_ms, inside = range_split(prof, NTT_RANGE)
    ours = tuple(f"{c}(" for spec in KERNELS.values() for c in spec[2])
    plain_in = [(n, ms) for name, (n, ms) in inside.items() if not name.startswith(ours)]
    log(f"profile: {tag} NTT ({NTT_RANGE}): {n_spans} device spans, {span_ms:.1f} ms summed; "
        f"device events inside {sum(ms for _n, ms in inside.values()):.1f} ms, of which plain torch "
        f"{sum(ms for _n, ms in plain_in):.1f} ms over {sum(n for n, _ms in plain_in)} launches")
    top = sorted(on_dev, key=dev_us, reverse=True)[:10]
    mine = [e for e in on_dev if e.key.startswith(ours) and e not in top]
    for e in top + mine:
        n_in, ms_in = inside.get(e.key, (0, 0.0))
        log(f"  ntt split {e.key[:80]}: inside {n_in} launches {ms_in:.1f} ms, "
            f"outside {e.count - n_in} launches {dev_us(e) / 1e3 - ms_in:.1f} ms")


def log_spans(tag: str, spans) -> None:
    """The port's spans (scroll_prover_tpu_torch/trace.py) as one table, by
    self time: calls, outermost seconds, self seconds and the summed counts
    (steps replayed, cache hits, copies, columns, elements, ...)."""
    from scroll_prover_tpu_torch import trace

    log(f"{tag} the port's spans (calls, outermost s, self s, counts), by self time:")
    for name, row in sorted(trace.summary(spans).items(), key=lambda kv: -kv[1]["self_s"]):
        counts = " ".join(f"{k} {v}" for k, v in row["attrs"].items())
        log(f"  span {name:28s} x{row['calls']:<6d} {row['total_s']:9.3f} s {row['self_s']:9.3f} s self  {counts}")


def profile_prove(run, proof, out_dir: str, tag: str = "prove"):
    """Two more proves, each checked against the first: one under
    torch.profiler with the port's spans on (device kernel time; busy share
    = summed device time over the prove's wall time; per kernel, device time
    per launch beside the bound per launch at the shapes this prove gave
    it), one under cProfile (host time by function). Returns the per-launch
    table, keyed by kernel and by "K1 <mode>" / "K1as <mode>"."""
    from scroll_prover_tpu_torch import trace

    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for key in KERNELS:
        reset_counts(wrapper(key))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bound_tally() as calls, torch.profiler.profile(activities=acts) as prof:
        trace.enable(True)
        try:
            again = run()
            torch.cuda.synchronize()
        finally:
            trace.enable(False)
    wall = time.perf_counter() - t0
    log_spans(f"profile: {tag}", trace.drain())
    if again != proof:
        fail("profiled prove gave other bytes")
    totals = tally_bounds(calls)
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again, and the device span of each
    # of the port's ranges covers kernels listed on their own
    on_dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(SPAN_PREFIX)]
    if not on_dev:
        fail("torch.profiler recorded no device events")
    busy = sum(dev_us(e) for e in on_dev) / 1e6
    top = sorted(on_dev, key=dev_us, reverse=True)[:15]
    with open(os.path.join(out_dir, f"{tag}_device_profile.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    log(f"profile: {tag} wall {wall:.2f} s under torch.profiler and the bound tally, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in top:
        log(f"  device {dev_us(e) / 1e3:10.1f} ms  x{e.count:<6d} {e.key[:90]}")
    ours = tuple(f"{c}(" for spec in KERNELS.values() for c in spec[2])
    plain = [e for e in on_dev if not e.key.startswith(ours) and not e.key.startswith(("Memcpy", "Memset"))]
    log(f"profile: plain torch device kernels {sum(e.count for e in plain)} launches, "
        f"{sum(dev_us(e) for e in plain) / 1e3:.1f} ms; port kernels "
        f"{sum(dev_us(e) for e in on_dev if e.key.startswith(ours)) / 1e3:.1f} ms")
    log_ntt_split(prof, on_dev, dev_us, tag)

    def row(label, launches, names, bnd):
        dev_ms = sum(dev_us(e) for e in on_dev if e.key.startswith(tuple(f"{c}(" for c in names))) / 1e3
        by = "bytes" if bnd[1] >= bnd[2] else "operations"
        log(f"  {label}: {launches} launches, device {dev_ms:.1f} ms, {dev_ms / launches:.4f} ms "
            f"per launch, bound {bnd[0] / launches:.4f} ms per launch ({by})")
        return {"launches": launches, "device_ms": dev_ms, "ms_per_launch": dev_ms / launches,
                "bound_ms_per_launch": bnd[0] / launches, "bound_by": by}

    per_launch = {}
    for key, spec in KERNELS.items():
        fn = wrapper(key)
        if not fn.launches:
            continue
        per_launch[key] = row(kernel_name(key), fn.launches, spec[2], totals[key])
        for (mode, launches), cname in zip(getattr(fn, "by_mode", {}).items(), spec[2]):
            if launches:
                per_launch[f"{key} {mode}"] = row(f"{key} {mode} {cname}", launches, (cname,),
                                                  totals[(key, mode)])
    log(f"profile {tag} per-launch: {json.dumps(per_launch)}")
    if host_profile(run, os.path.join(out_dir, f"{tag}_host_profile.txt"), top=15) != proof:
        fail("profiled prove gave other bytes")
    return per_launch


def synthetic_program(num_logs):
    """(code_hex, structLogs): the opcode byte at each logged pc is the
    logged op (the generator of the repo's witness tests)."""
    ops = ["PUSH1", "SLOAD", "MSTORE", "SHA3", "CALLDATACOPY"] * (num_logs // 5 + 1)
    code = bytearray()
    logs = []
    for op in ops[:num_logs]:
        pc = len(code)
        logs.append({"pc": pc, "op": op, "gas": 100000 - pc, "gasCost": 3, "depth": 1})
        if op == "PUSH1":
            code += bytes([0x60, 0x01])
        else:
            code.append({"SLOAD": 0x54, "MSTORE": 0x52, "SHA3": 0x20, "CALLDATACOPY": 0x37}[op])
    return "0x" + code.hex(), logs


def synthetic_trace(num_txs, num_logs) -> dict:
    """The JSON block trace of the repo's witness tests (each transaction a
    CALL into the sha256 precompile over the same program)."""
    txs, ers = [], []
    for i in range(num_txs):
        txs.append({
            "type": 0, "nonce": i, "txHash": "0x" + "ab" * 32,
            "gas": 21000 + 500 * i, "gasPrice": "0x3b9aca00",
            "from": "0x" + "11" * 20, "to": "0x" + "22" * 20,
            "chainId": "0x82750", "value": "0x1", "data": "0xdeadbeef",
            "isCreate": False, "v": "0x1", "r": "0x2", "s": "0x3",
        })
        code_hex, logs = synthetic_program(num_logs)
        ers.append({
            "gas": 21000, "failed": False, "returnValue": "",
            "from": {"address": "0x" + "11" * 20, "nonce": i},
            "byteCode": code_hex, "structLogs": logs,
            "callTrace": {"type": "CALL", "from": "0x" + "11" * 20,
                          "to": "0x0000000000000000000000000000000000000002", "input": "0x" + "00" * 64},
        })
    return {
        "chainID": 534352, "version": "test",
        "coinbase": {"address": "0x" + "33" * 20},
        "header": {"number": "0x64", "gasUsed": "0xa410", "timestamp": "0x5"},
        "transactions": txs,
        "storageTrace": {
            "rootBefore": "0x" + "01" * 32, "rootAfter": "0x" + "02" * 32,
            "proofs": {"0x" + "11" * 20: ["0xaa", "0xbb"]},
            "storageProofs": {"0x" + "22" * 20: {"0x0": ["0xcc"]}},
        },
        "executionResults": ers,
        "withdraw_trie_root": "0x" + "03" * 32,
        "startL1QueueIndex": 7,
    }


class _Marks(logging.Handler):
    """Records (message, seconds) of the prover's progress lines, after a
    synchronize, so that each mark's time includes the device work queued
    before it."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks = []
        self.rss = []  # the host's RSS in GiB at each mark

    def emit(self, record):
        torch.cuda.synchronize()
        self.marks.append((record.getMessage(), time.perf_counter()))
        self.rss.append(proc_status_gib("VmRSS"))


class _MemMarks(_Marks):
    """_Marks that also keep, at each mark, the device memory allocated and
    the peak since the mark before (the peak is then reset), and the
    largest of those peaks in `max_peak` (GiB)."""

    def __init__(self):
        super().__init__()
        self.alloc = []
        self.peaks = []
        self.max_peak = 0.0

    def emit(self, record):
        super().emit(record)
        self.alloc.append(torch.cuda.memory_allocated() / 2**30)
        self.peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        self.max_peak = max(self.max_peak, self.peaks[-1])
        torch.cuda.reset_peak_memory_stats()

    def prove_marks(self) -> list:
        """[(label, allocated GiB, peak GiB since the mark before)] of the
        prover's "prove[...]" marks."""
        return [(msg[len("prove["):msg.index("]")], a, p) for (msg, _t), a, p in zip(self.marks, self.alloc, self.peaks)
                if msg.startswith("prove[")]


@contextlib.contextmanager
def prover_marks(logger: str = "scroll_prover_tpu_torch.proof_system.plonk.prover", tag: str = "chunk prove",
                 marks=None):
    """Yields a _Marks (or `marks`) attached to `logger` (the prover's, or
    the package's to hear the ladder's layers as well) for the block; the
    coset cache's cap is logged as the prove reports it."""
    marks = marks or _Marks()
    plog = logging.getLogger(logger)
    level = plog.level
    plog.addHandler(marks)
    plog.setLevel(logging.INFO)
    try:
        yield marks
    finally:
        plog.removeHandler(marks)
        plog.setLevel(level)
    for msg, _t in marks.marks:
        if msg.startswith("quotient coset cache"):
            log(f"{tag}: {msg}")


def rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def proc_status_gib(field: str) -> float:
    """A kB field of /proc/self/status (VmRSS: the RSS now), in GiB."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 2**20
    raise KeyError(field)


def host_profile(run, out_path: str, top: int = 20):
    """run() under cProfile; the table by own time into out_path and its
    top lines printed. Returns run's result."""
    import cProfile
    import io
    import os
    import pstats

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    out = run()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(60)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write(buf.getvalue())
    log(f"profile: wall {wall:.2f} s under cProfile ({os.path.basename(out_path)}); top host functions by own time:")
    stats = pstats.Stats(pr).stats
    for (fn, line, name), (_cc, nc, tt, ct, _callers) in sorted(stats.items(), key=lambda kv: kv[1][2],
                                                               reverse=True)[:top]:
        log(f"  host {tt:8.3f} s own {ct:8.3f} s cum x{nc:<8d} {os.path.basename(fn)}:{line} {name}")
    return out


def family_cs():
    """A ConstraintSystem that records, for each advice and fixed column, the
    sub-circuit whose configure made it (the outermost configure below the
    super circuit's)."""
    from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem
    from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit

    class FamilyCS(ConstraintSystem):
        def __init__(self):
            super().__init__()
            self.family = {"advice": [], "fixed": []}

        def _note(self, kind):
            f, sub = sys._getframe(2), None
            while f is not None:
                me = f.f_locals.get("self") if f.f_code.co_name == "configure" else None
                if isinstance(me, ScrollSuperCircuit):
                    break
                if me is not None:
                    sub = me
                f = f.f_back
            self.family[kind].append(type(sub).__name__ if sub is not None else "ScrollSuperCircuit")

        def advice_column(self):
            self._note("advice")
            return super().advice_column()

        def fixed_column(self):
            self._note("fixed")
            return super().fixed_column()

    return FamilyCS()


def nonzero_by_family(cs, tables) -> dict:
    """{family: {kind: [columns, non-zero cells]}} of an assignment made on a
    family_cs()."""
    import numpy as np

    out = {}
    for kind in ("advice", "fixed"):
        for fam, nz in zip(cs.family[kind], np.count_nonzero(tables[kind], axis=1)):
            cell = out.setdefault(fam, {}).setdefault(kind, [0, 0])
            cell[0] += 1
            cell[1] += int(nz)
    return out


def chunk_proof(dev):
    """Phase 5: the chunk's inner proof at k = CHUNK_K (see the module
    docstring). Returns the phase seconds, a closure that proves again, the
    proof and the chunk's ChunkInfo."""
    from scroll_prover_tpu_torch.l2types import BlockTrace
    from scroll_prover_tpu_torch.proof_system.kzg import SRS
    from scroll_prover_tpu_torch.proof_system.plonk import prover as pv
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.mock import _pad_instance
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify
    from scroll_prover_tpu_torch.prover.chunk_info import ChunkInfo
    from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
    from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit, chunk_instance

    secs = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"chunk {name}: {secs[name]:.2f} s (peak host RSS so far {rss_gib():.2f} GiB)")
        return out

    trace = step("trace_json", lambda: synthetic_trace(CHUNK_TXS, CHUNK_LOGS))
    wb = step("witness", lambda: chunk_trace_to_witness_block([BlockTrace.from_json(trace)]))
    del trace
    info = ChunkInfo.from_witness_block(wb)
    circ = ScrollSuperCircuit.new_from_block(wb)
    k = step("min_k", circ.min_k)
    log(f"chunk: {wb.num_txs} txs, {wb.num_steps} steps, {len(wb.rw_rows)} rw rows, min_k {k}, "
        f"{len(info.tx_bytes)} transaction bytes")
    if k != CHUNK_K:
        fail(f"the synthetic chunk's min_k is {k}, not {CHUNK_K}")
    srs = step("srs_generate_fast", lambda: SRS.generate_fast(k, device=dev))
    instance = [chunk_instance(wb)]

    def assign_once():
        cs = family_cs()
        circ.configure(cs)
        n = 1 << k
        return cs, circ.assign(cs, n, _pad_instance(cs, n, instance))

    cs, tables = step("assign", assign_once)
    log(f"chunk circuit: {cs.num_advice} advice, {cs.num_fixed} fixed, {cs.num_instance} instance columns, "
        f"{len(cs.perm_columns)} permutation columns, {len(cs.lookups)} lookups, {len(cs.gates)} gates; "
        f"row usage {json.dumps(circ.row_usages_)}")

    fams = step("nonzero_count", lambda: nonzero_by_family(cs, tables))
    del tables
    n = 1 << k
    for kind in ("advice", "fixed"):
        cols = sum(v[kind][0] for v in fams.values() if kind in v)
        nz = sum(v[kind][1] for v in fams.values() if kind in v)
        log(f"chunk {kind}: {cols} columns, {100 * nz / (cols * n):.3f}% of cells non-zero; by family "
            + ", ".join(f"{fam} {v[kind][0]} cols {100 * v[kind][1] / (v[kind][0] * n):.3f}%"
                        for fam, v in fams.items() if kind in v))
    pk, vk = step("keygen", lambda: keygen(srs, k, circ, instance))

    def prove_chunk():
        return pv.prove(srs, pk, circ, instance, seed=b"chip-smoke-chunk", multiopen="shplonk")

    def prove_again():
        with prover_marks():
            return prove_chunk()

    with prover_marks() as marks:
        t_start = time.perf_counter()
        proof = step("prove", prove_chunk)
    prev = t_start
    for msg, t in marks.marks:  # "prove[<phase>] <s>" or "quotient coset <r>/<ratio> done"
        if msg.startswith("prove["):
            label = msg[len("prove["):msg.index("]")]
        elif msg.endswith(" done"):
            label = msg.removesuffix(" done")
        else:
            continue
        log(f"chunk prove: {label}: {t - prev:.2f} s")
        prev = t
    cosets = [m for m, _ in marks.marks if m.startswith("quotient coset") and m.endswith(" done")]
    ratio = vk.domain.extended_n // vk.domain.n
    if len(cosets) != ratio:
        fail(f"the chunk prove walked {len(cosets)} cosets, not {ratio} (streamed quotient)")
    ok = step("verify", lambda: verify(srs, vk, instance, proof, multiopen="shplonk"))
    if not ok:
        fail(f"the k={k} chunk proof did not verify")
    bad = bytearray(proof)
    bad[100] ^= 1
    if verify(srs, vk, instance, bytes(bad), multiopen="shplonk"):
        fail(f"a tampered k={k} chunk proof verified")
    digest = hashlib.sha256(proof).hexdigest()
    log(f"chunk proof: {len(proof)} bytes, verify True, tampered proof rejected; sha256 {digest} "
        f"(pinned {CHUNK_PROOF_SHA256})")
    if digest != CHUNK_PROOF_SHA256:
        fail(f"the k={k} chunk proof's bytes differ from the pinned proof")
    return secs, prove_again, proof, info


def note_k2(passes: dict, *a) -> None:
    """Record one K2 call in `passes` by its pass: shape, level, stride, the
    table products it applies, last or not, in place or not. The butterflies
    do not depend on the data; the pass and its tables do (kept by
    reference: the domains hold them)."""
    x, tw, k, stride, twmid, pre, post, n_inv, last, inplace = a
    key = (tuple(x.shape), k, stride, *(t is not None for t in (twmid, pre, post, n_inv)), last, inplace)
    n_calls, tables = passes.get(key, (0, (tw, twmid, pre, post, n_inv)))
    passes[key] = (n_calls + 1, tables)


def k2_pass_checks(passes: dict, dev, gen, where: str) -> int:
    """Run after a phase's launch counts are read. Holds K2 against its
    plain version at every pass that note_k2 recorded (the phase's own
    tables, random values), CUDA-event ms of 20 launches beside the bound
    at each, after k2_control; fails on any difference. Returns the largest
    max_abs_err (0)."""
    from scroll_prover_tpu_torch.fields.limbs import FR_LIMB
    from scroll_prover_tpu_torch.ops import ntt_tile as nt

    worst = 0
    k2_control(dev, gen, where)
    for key, (n_calls, tables) in sorted(passes.items()):
        tw, twmid, pre, post, n_inv = (None if t is None else t.to(dev) for t in tables)
        shape, k, stride, last, inplace = key[0], key[1], key[2], key[-2], key[-1]
        x = rand_field(FR_LIMB, shape[0] * shape[1], gen, dev).reshape(shape)

        def call(fn, v):
            return fn(v, tw, k, stride, twmid, pre, post, n_inv, last, inplace)

        want = call(nt._ntt_pass_plain, x)
        err = max_abs_err(call(nt._ntt_pass_k2, x.clone()), want)
        del want
        worst = max(worst, err)
        k2_ms, _ = event_ms(lambda: call(nt._ntt_pass_k2, x), 20)
        b2 = bound(*work("K2", x, tw, k, stride, twmid, pre, post, n_inv, last, inplace))
        tabs = [name for name, t in zip(("twmid", "pre", "post", "n_inv"), (twmid, pre, post, n_inv))
                if t is not None]
        log(f"K2 at {where}'s pass {shape}, k = {k}, stride {stride}, tables {'+'.join(tabs) or 'none'}"
            f"{', last' if last else ''}{', in place' if inplace else ''} ({n_calls} calls): {k2_ms:.4f} ms "
            f"by CUDA events, bound {b2[0]:.4f} ms ({b2[1]}), {100 * b2[0] / k2_ms:.1f}% of bound; "
            f"vs plain version: max_abs_err {err}")
        del x
    if worst != 0:
        fail(f"K2 disagrees with its plain version at {where}'s passes")
    return worst


@contextlib.contextmanager
def path_inputs(keys=("K2", "K3")):
    """While phase 5 (or a layer of phase 6) runs: the non-zero digits of
    every K3 call (device counts, summed after the phase), host copies of
    the arguments of the K3 call with the most non-zero digits among the
    widest (one of the commit groups: this waits for the card at each K3
    call), and the shape, k and twiddles of each distinct K2 call, for the
    kernels of `keys`. Yields the dict it fills."""
    seen = {"k3_live": [], "k3_digits": 0, "k3": None, "k3_rank": (-1, -1), "k2": {}}

    def hook(key, *a):
        if key == "K3":
            pts, digs, signs, B = a
            live = torch.count_nonzero(digs)
            seen["k3_live"].append(live)
            seen["k3_digits"] += digs.numel()
            rank = (digs.shape[0], int(live))
            if rank > seen["k3_rank"]:
                seen["k3_rank"] = rank
                seen["k3"] = (pts.cpu(), digs.cpu(), signs.cpu(), B)
        else:
            note_k2(seen["k2"], *a)

    with hooked(keys, hook):
        yield seen


def k4_check(raw, where: str) -> dict:
    """K4 on a K3 output `raw` (whole columns) against its plain version,
    limb for limb, its CUDA-event ms beside the bound (and each of its two
    launches timed alone through its C entry); its affine
    points against the host fold of the bucket table the reduction before
    K4's redesign gave (`_lane_reduce_plain` on the card: what its six halving
    launches gave, bit for bit); and the reduction per call on the host
    clock: K4 with the (C, 3, 8) readback and `_affine_columns`, beside
    the old reduction's host part, the (C * 43, 33, 3, 16) table's readback
    and `_host_fold_mont` per column (the old six launches' device time is
    in PERF.md, from the tree before). Fails on any difference. Returns
    the numbers."""
    from scroll_prover_tpu_torch.fields.limbs import limbs_from_torch
    from scroll_prover_tpu_torch.ops import cuda_lib
    from scroll_prover_tpu_torch.ops import msm_tile as mt

    W, B = mt._wb(mt.MSM_C)
    CW, S = raw.shape[:2]
    C = CW // W
    k4_ms, p_ms, ko, po = time_turns(lambda: mt._msm_reduce_k4(raw), lambda: mt._msm_reduce_plain(raw), 3)
    err = max_abs_err(ko, po)
    del ko, po
    b = bound(*work("K4", raw))
    lib = cuda_lib.lib("msm")
    sums = torch.empty((CW, B - 1, 3, 8), dtype=raw.dtype, device=raw.device)
    out = torch.empty((C, 3, 8), dtype=raw.dtype, device=raw.device)
    slot_ms, rc = event_ms(lambda: lib.spt_msm_slot_sums(
        sums.data_ptr(), raw.data_ptr(), CW, S, cuda_lib.curve_params(), cuda_lib.stream_ptr(sums)), 3)
    cuda_lib.check(rc, "K4 msm_slot_sums")
    fold_k_ms, rc = event_ms(lambda: lib.spt_msm_window_fold(
        out.data_ptr(), sums.data_ptr(), C, W, mt.MSM_C, cuda_lib.curve_params(), cuda_lib.stream_ptr(out)), 3)
    cuda_lib.check(rc, "K4 msm_window_fold")
    torch.cuda.synchronize()
    del sums, out
    affine = HOST_ORACLE["_affine_columns"]
    new_ms, got = wall_ms(lambda: affine(mt._msm_reduce_k4(raw).cpu().numpy()))
    old = mt._bucket_table(mt._lane_reduce_plain(raw))
    read_ms, tbl = wall_ms(lambda: limbs_from_torch(old).reshape(C, W, B, 3, 16))
    fold_ms, want = wall_ms(lambda: [HOST_ORACLE["_host_fold_mont"](t, mt.MSM_C) for t in tbl])
    out = {"shape": list(raw.shape), "columns": C, "ms": k4_ms, "plain_ms": p_ms, "bound_ms": b[0],
           "bound_by": b[1], "max_abs_err": err, "slot_sums_ms": slot_ms, "window_fold_ms": fold_k_ms,
           "reduction_wall_ms": new_ms, "old_readback_ms": read_ms,
           "old_host_fold_ms": fold_ms, "readback_bytes": 96 * C, "old_readback_bytes": tbl.nbytes}
    log(f"K4 at {where}'s shape {tuple(raw.shape)} ({C} columns): {k4_ms:.4f} ms by CUDA events (2 launches: "
        f"slot sums {slot_ms:.4f} ms, window sums and fold {fold_k_ms:.4f} ms, each timed alone), "
        f"bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / k4_ms:.1f}% of bound; plain {p_ms:.1f} ms; vs plain "
        f"version: max_abs_err {err}; the reduction per call, host clock: K4 + {96 * C} B readback + affine "
        f"{new_ms:.2f} ms; the old host part: {tbl.nbytes} B readback {read_ms:.2f} ms + host fold {fold_ms:.2f} ms")
    if err != 0:
        fail(f"K4 disagrees with its plain version at {where}'s shape")
    if got != want:
        fail(f"K4's affine points differ from the host fold of the old bucket table at {where}'s shape")
    return out


def chunk_kernel_checks(seen, dev, gen, where: str = "the chunk") -> dict:
    """Run after phase 5's (or 6's) launch counts are read. Holds K3 against
    its plain version on the captured commit group (the path's own points,
    digits and signs), K4 against its plain version on K3's output there,
    and K2 against its plain version at every pass the path gave it
    (k2_pass_checks); CUDA-event ms beside the bound at each. Returns
    {key: max_abs_err}."""
    from scroll_prover_tpu_torch.ops import msm_tile as mt

    live = int(torch.stack(seen["k3_live"]).sum())
    log(f"{where}: K3 digits: {live} of {seen['k3_digits']} non-zero "
        f"({100 * live / seen['k3_digits']:.3f}%) over {len(seen['k3_live'])} calls")
    pts, digs, signs, B = (t.to(dev) if torch.is_tensor(t) else t for t in seen["k3"])
    k3_ms, raw = event_ms(lambda: mt._accum_k3(pts, digs, signs, B), 2)
    b3 = bound(*work("K3", pts, digs, signs, B))
    # the plain version walks each column-window alone: run it over slices
    # of rows (2^28 digits each) so that its int64 copies fit beside the rest
    step = max(1, (1 << 28) // digs.shape[1])
    p_ms, errs = 0.0, {"K3": 0}
    for a in range(0, digs.shape[0], step):
        ms, plain = wall_ms(lambda: mt._accum_v2_plain(pts, digs[a:a + step], signs[a:a + step], B))
        p_ms += ms
        errs["K3"] = max(errs["K3"], max_abs_err(raw[a:a + step], plain))
        del plain
    log(f"K3 at {where}'s shape {tuple(digs.shape)} ({seen['k3_rank'][1]} non-zero digits): {k3_ms:.3f} ms "
        f"by CUDA events, bound {b3[0]:.3f} ms ({b3[1]}); vs plain version ({p_ms / 1e3:.1f} s wall, "
        f"{step} rows a call): max_abs_err {errs['K3']}")
    del pts, digs, signs
    k4 = k4_check(raw, where)
    errs["K4"] = k4["max_abs_err"]
    seen["k4"] = k4
    del raw
    errs["K2"] = k2_pass_checks(seen["k2"], dev, gen, where)
    for key, err in errs.items():
        if err != 0:
            fail(f"{key} disagrees with its plain version at {where}'s shapes")
    return errs


def counted(keys, fn):
    """Run fn with the launch counts of `keys` set to 0 just before and read
    just after; then the counts found before are put back, so that a phase
    around a counted step leaves the step's launches out. Returns (fn's
    result, {key: launches during fn}, {key: {mode: launches}} for K1's
    modes). Fails if one stayed at 0, if K4 took other than 2 launches a
    K3 call (one MSM), or if fn called the host fold `_host_fold_mont`."""
    counters = {key: wrapper(key) for key in keys}
    saved = {key: (c.launches, dict(getattr(c, "by_mode", {}))) for key, c in counters.items()}
    for c in counters.values():
        reset_counts(c)
    host0 = host_mark()
    out = fn()
    host = host_since(host0)
    launches = {key: c.launches for key, c in counters.items()}
    by_mode = {key: dict(c.by_mode) for key, c in counters.items() if hasattr(c, "by_mode")}
    for key, c in counters.items():
        c.launches = saved[key][0]
        if hasattr(c, "by_mode"):
            c.by_mode = saved[key][1]
    missing = [key for key, v in launches.items() if not v]
    if missing:
        fail(f"the path never launched {missing}")
    if "K4" in launches and launches["K4"] != 2 * launches["K3"]:  # every MSM call: one K3, one K4 (2 launches)
        fail(f"K4 launched {launches['K4']} times for {launches['K3']} MSM calls, not 2 a call")
    if host["_host_fold_mont"][0]:
        fail(f"the path called the host fold _host_fold_mont {host['_host_fold_mont'][0]} times")
    return out, launches, by_mode


def gadget_seconds(marks, gadget: str, where: str) -> tuple[float, float]:
    """(seconds of the layer's recording pass, seconds of its assignment)
    from its gadget's marks: the pass runs once (min_k) and the assignment
    replays its record."""
    build = [t for msg, t in marks if msg.startswith(f"{gadget} build")]
    replay = [t for msg, t in marks if msg.startswith(f"{gadget} assignment replay")]
    if len(build) != 2 or len(replay) != 2:
        fail(f"{where}: its gadget's marks are not one recording pass and one replay")
    return build[1] - build[0], replay[1] - replay[0]


def ladder_layer(prover, prev, prev_vk, layer: int, mo: str):
    """One layer of phase 6 through the facade's own layer code
    (ChunkProver._compress_layer: min_k's recording pass, the SRS, keygen
    with the assignment's replay, the host accumulator, the prove), then
    verify and the accumulator's pairing. Returns (payload, vk, stats,
    circuit)."""
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, check_accumulator, verify
    from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = {key: wrapper(key).launches for key in LADDER_PATH}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prover_marks("scroll_prover_tpu_torch", f"layer {layer} prove", _MemMarks()) as marks:
        payload, vk, circ = prover._compress_layer(prev, prev_vk, layer, "ladder", mo,
                                                   seed=LADDER_SEED + bytes([layer]))
    at = {}
    for msg, t in marks.marks:
        for key in ("verifier circuit:", "srs ready", "keygen done", "proved"):
            if key in msg and msg.startswith("chunk ladder: layer"):
                at[key] = t
    count, assign = gadget_seconds(marks.marks, "verifier-gadget", f"layer {layer}")
    secs = {
        "count": count,
        "srs": at["srs ready"] - at["verifier circuit:"],
        "assign": assign,
        "keygen": at["keygen done"] - at["srs ready"] - assign,
        "prove": at["proved"] - at["keygen done"],
    }
    prev_t = at["keygen done"]
    for msg, t in marks.marks:
        if t > at["keygen done"] and msg.startswith("prove["):
            log(f"layer {layer} prove: {msg[len('prove['):msg.index(']')]}: {t - prev_t:.2f} s")
            prev_t = t
    srs = prover.params_map[vk.k]
    inst = [payload.instances]
    t1 = time.perf_counter()
    ok = verify(srs, vk, inst, payload.proof, multiopen=mo)
    secs["verify"] = time.perf_counter() - t1
    if not ok:
        fail(f"the layer-{layer} proof did not verify")
    t1 = time.perf_counter()
    if not check_accumulator(srs, *acc_from_limbs(payload.instances[:ACC_CELLS])):
        fail(f"the layer-{layer} accumulator fails its pairing")
    secs["accumulator"] = time.perf_counter() - t1
    secs["layer"] = time.perf_counter() - t0
    cs = vk.cs
    stats = {
        "rows": circ._rows, "k": vk.k, "advice": cs.num_advice, "fixed": cs.num_fixed, "lookups": len(cs.lookups),
        "gates": len(cs.gates), "permutation": len(cs.perm_columns), "extended_k": vk.domain.extended_k,
        "instances": len(payload.instances), "proof_bytes": len(payload.proof), "seconds": secs,
        "peak_device_gib": max(marks.max_peak, torch.cuda.max_memory_allocated() / 2**30),
        # device memory at the prove's marks: [label, allocated, peak since the mark before] (GiB)
        "prove_marks_gib": [[label, round(a, 2), round(p, 2)] for label, a, p in marks.prove_marks()],
        # the largest RSS at the layer's progress marks (a process cannot
        # reset its peak everywhere), beside the process's peak so far
        "peak_rss_at_marks_gib": max(marks.rss),
        "process_peak_rss_gib": rss_gib(),
        "launches": {key: wrapper(key).launches - before[key] for key in LADDER_PATH},
    }
    log(f"layer {layer}: {json.dumps(stats)}")
    return payload, vk, stats, circ


LOWMEM_SETTINGS = {"SPT_LOWMEM": "1", "SPT_VALS_RESIDENT": "4", "SPT_ADVICE_COEFF_RESIDENT": "4",
                   "SPT_PACK_RESIDENT": "1"}  # phase 6b's bounded residency


@contextlib.contextmanager
def lowmem_switches():
    """LOWMEM_SETTINGS in the environment and the prover's module switches
    (_LOWMEM, _PACK, read at its import) on for the block; both put back
    as they were after it."""
    from scroll_prover_tpu_torch.proof_system.plonk import prover as pv

    env = {key: os.environ.get(key) for key in LOWMEM_SETTINGS}
    switches = (pv._LOWMEM, pv._PACK)
    os.environ.update(LOWMEM_SETTINGS)
    pv._LOWMEM = pv._PACK = True
    try:
        yield
    finally:
        pv._LOWMEM, pv._PACK = switches
        for key, v in env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def launches_of(keys, fn):
    """(fn's result, {key: launches during fn}) without counted()'s check
    that each was launched (keygen launches no K1as)."""
    counters = {key: wrapper(key) for key in keys}
    before = {key: c.launches for key, c in counters.items()}
    out = fn()
    return out, {key: c.launches - before[key] for key, c in counters.items()}


def log_prove_phases(marks, t_start: float, tag: str) -> None:
    """The seconds of each of a prove's phases, from its marks."""
    prev = t_start
    for msg, t in marks.marks:
        if msg.startswith("prove["):
            log(f"{tag}: {msg[len('prove['):msg.index(']')]}: {t - prev:.2f} s")
            prev = t


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def evm_tail(prover, p1, vk1, circ1, l1_stats, dev, rows) -> dict:
    """Phase 6b (see the module docstring): layer 1's VerifierCircuit keyed
    again and proved with bounded residency and a checkpoint (seeded with
    EVM_TAIL_SEED) under layer 6's outer settings (the Keccak transcript,
    GWC), resumed from that checkpoint cut inside the quotient, verified on
    the host with its accumulator folded, then wrapped as the last layer of
    a BundleProof whose release artifacts BatchProver writes (the full
    in-bytecode verifier among them) and whose verification BatchProver
    runs in the port's EVM. Every check is fatal. Returns the step's
    stats."""
    import shutil
    import tempfile

    from scroll_prover_tpu_torch.evm.interpreter import EvmRevert, deploy_and_call
    from scroll_prover_tpu_torch.evm.full_verifier import proof_calldata
    from scroll_prover_tpu_torch.proof_system.plonk.checkpoint import ProveCheckpoint
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, verify
    from scroll_prover_tpu_torch.proof_system.transcript import KeccakTranscript
    from scroll_prover_tpu_torch.prover import BatchProver, BundleProof
    from scroll_prover_tpu_torch.prover.proofs import ProofPayload
    from scroll_prover_tpu_torch.prover.protocol import protocol_from_vk
    from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    host0 = host_mark()
    secs = {}
    keys = [key for key, (_pk, vk) in prover._kg._cache.items() if vk is vk1]
    if len(keys) != 1:
        fail("phase 6b: layer 1's keys are not in the prover's keygen cache")
    srs = prover.params_map[vk1.k]
    inst = [list(p1.instances)]
    fold = acc_from_limbs(inst[0][:ACC_CELLS])
    ck_dir = tempfile.mkdtemp(prefix="spt_lowmem_ckpt_")
    fingerprint = f"layer1-{vk1.transcript_repr():064x}"
    stats = {"settings": dict(LOWMEM_SETTINGS), "checkpoint_dir": ck_dir}
    try:
        with lowmem_switches():
            # a. the lowmem keygen of phase 6's layer-1 circuit (its tables and
            # the copies they registered, kept from phase 6's keygen) over a
            # new checkpoint
            ck = ProveCheckpoint(ck_dir, fingerprint)
            ck.meta["seed"] = EVM_TAIL_SEED.hex()  # as a resumed directory would hold it
            ck._flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (pk, vk), kg_launches = launches_of(EVM_TAIL_PATH, lambda: keygen(srs, vk1.k, circ1, ckpt=ck))
            torch.cuda.synchronize()
            secs["keygen"] = time.perf_counter() - t0
            if vk.to_bytes() != vk1.to_bytes():
                fail("phase 6b: the lowmem keygen's vk bytes differ from phase 6's layer-1 vk")
            if pk.fixed_polys is not None or pk.sigma_polys is not None:
                fail("phase 6b: the lowmem keygen made coefficient forms")
            # the lowmem pk takes the place of phase 6's (whose 36 resident
            # coefficient forms go)
            prover._kg._cache[keys[0]] = (pk, vk1)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"phase 6b keygen (SPT_LOWMEM, checkpoint {ck_dir}): {secs['keygen']:.2f} s; vk equal to phase 6's; "
                f"launches {json.dumps(kg_launches)}")

            # b. the bounded, checkpointed prove (the step's counted path)
            starts = {}

            def run():
                torch.cuda.synchronize()
                t0 = starts["prove"] = time.perf_counter()
                out = prove(srs, pk, circ1, inst, transcript_cls=KeccakTranscript, multiopen="gwc", ckpt=ck)
                torch.cuda.synchronize()
                secs["prove"] = time.perf_counter() - t0
                vk.domain.release()  # as _compress_layer does after its prove
                return out

            torch.cuda.reset_peak_memory_stats()
            with prover_marks(tag="phase 6b prove", marks=_MemMarks()) as pm:
                proof, launches, by_mode = counted(EVM_TAIL_PATH, run)
            peak_dev = max(pm.max_peak, torch.cuda.max_memory_allocated() / 2**30)
            log_prove_phases(pm, starts["prove"], "phase 6b bounded prove")
            ck_bytes = dir_bytes(ck_dir)
            free = shutil.disk_usage(ck_dir).free
            log(f"phase 6b bounded prove: {secs['prove']:.2f} s, peak device {peak_dev:.2f} GiB; checkpoint "
                f"{ck_bytes} bytes ({ck_bytes / 2**30:.3f} GiB) in {len(os.listdir(ck_dir))} files, "
                f"{free / 2**30:.1f} GiB free on its disk")
            unbounded = {label: (a, p) for label, a, p in l1_stats["prove_marks_gib"]}
            for label, a, p in pm.prove_marks():
                ua, up = unbounded.get(label, (float("nan"), float("nan")))
                log(f"phase 6b memory at prove[{label}]: allocated {a:.2f} GiB, peak since the mark before {p:.2f} "
                    f"GiB (phase 6's unbounded layer-1 prove: {ua:.2f}, {up:.2f})")
            l1_peak = max((p for _l, _a, p in l1_stats["prove_marks_gib"]), default=float("nan"))
            log(f"phase 6b peak over the prove's marks {max(p for _l, _a, p in pm.prove_marks()):.2f} GiB; "
                f"phase 6's layer-1 prove {l1_peak:.2f} GiB")

            # c. the resume: later phases and half of the cosets cut, a fresh
            # circuit object (a copy of phase 6's, which shares its
            # assignment) and checkpoint handle, as a new process would make
            with open(os.path.join(ck_dir, "meta.json")) as fh:
                meta = json.load(fh)
            for tag in ("p4_h", "p6_w"):
                meta["points"].pop(tag, None)
            meta["scalars"].pop("p5_evals", None)
            with open(os.path.join(ck_dir, "meta.json"), "w") as fh:
                json.dump(meta, fh)
            cosets = sorted((f for f in os.listdir(ck_dir) if f.startswith("coset_")), key=lambda f: int(f[6:-4]))
            for f in cosets[len(cosets) // 2:]:
                os.remove(os.path.join(ck_dir, f))
            kept = {"points": sorted(meta["points"]),
                    "lookups": sorted(f for f in os.listdir(ck_dir) if f.startswith("lookup_")),
                    "cosets": len(cosets) // 2}

            def resume():
                torch.cuda.synchronize()
                t0 = starts["resume"] = time.perf_counter()
                out = prove(srs, pk, copy.copy(circ1), inst, transcript_cls=KeccakTranscript, multiopen="gwc",
                            ckpt=ProveCheckpoint(ck_dir, fingerprint))
                torch.cuda.synchronize()
                secs["resume"] = time.perf_counter() - t0
                vk.domain.release()
                return out

            with prover_marks(tag="phase 6b resume") as rm:
                resumed, res_launches, _ = counted(EVM_TAIL_PATH, resume)
            from_ck = [m for m, _t in rm.marks if m.startswith("quotient coset") and m.endswith("(checkpoint)")]
            log_prove_phases(rm, starts["resume"], "phase 6b resume")
            log(f"phase 6b resume: {secs['resume']:.2f} s ({100 * secs['resume'] / secs['prove']:.1f}% of the "
                f"bounded prove); from the checkpoint: the commit groups {kept['points']}, "
                f"{len(kept['lookups'])} lookups, {len(from_ck)} of {len(cosets)} cosets; launches {json.dumps(res_launches)}")
            if len(from_ck) != kept["cosets"]:
                fail(f"phase 6b: the resume took {len(from_ck)} cosets from the checkpoint, not {kept['cosets']}")
            if resumed != proof:
                fail("phase 6b: the resumed proof's bytes differ from the bounded prove's")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    for key, v in launches.items():
        rows[key]["evm_tail_launches"] = v
    for key, modes in by_mode.items():
        for mode, v in modes.items():
            rows[key]["modes"][mode]["evm_tail_launches"] = v

    # the host verify and the EVM on the bounded prove's proof, at the
    # package's defaults again
    t0 = time.perf_counter()
    ok = verify(srs, vk1, inst, proof, transcript_cls=KeccakTranscript, fold_accumulator=fold, multiopen="gwc")
    secs["host_verify"] = time.perf_counter() - t0
    if not ok:
        fail("phase 6b: the Keccak/GWC layer-1 proof did not verify with its accumulator folded")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        rejected = not verify(srs, vk1, inst, bytes(bad), transcript_cls=KeccakTranscript, fold_accumulator=fold,
                              multiopen="gwc")
    except (AssertionError, ValueError):
        rejected = True
    if not rejected:
        fail("phase 6b: a tampered Keccak/GWC proof verified on the host")

    payload = ProofPayload(proof=proof, instances=inst[0],
                           protocol=protocol_from_vk(vk1, len(inst[0]), multiopen="gwc"),
                           vk_id=hex(vk1.transcript_repr()))
    bundle = BundleProof(layers=[p1, payload])
    bp = BatchProver(prover.params_map, device=dev)
    out_dir = tempfile.mkdtemp(prefix="spt_evm_tail_")
    try:
        t0 = time.perf_counter()
        bp._dump_release_artifacts(bundle, payload, out_dir)
        secs["gen_full_verifier"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, "evm_verifier.bin"), "rb") as fh:
            code = fh.read()
        yul_bytes = os.path.getsize(os.path.join(out_dir, "evm_verifier.yul"))
        t0 = time.perf_counter()
        gas = bp.evm_verify_bundle(bundle, out_dir)
        secs["evm_accept"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir)
    if gas is None or gas <= 100_000:
        fail(f"phase 6b: the EVM verifier did not accept the bundle (gas {gas})")
    negatives = {}
    cell = list(inst[0])
    cell[ACC_CELLS] += 1  # the chunk instance's chain id, passed through
    for name, calldata in (("flipped proof byte", proof_calldata(inst[0], bytes(bad))),
                           ("changed instance cell", proof_calldata(cell, proof))):
        t0 = time.perf_counter()
        try:
            got = deploy_and_call(code, calldata)
        except EvmRevert:
            got = None
        secs[f"evm_{name.replace(' ', '_')}"] = time.perf_counter() - t0
        if got is not None:
            fail(f"phase 6b: the EVM verifier charged {got} gas for a call with a {name} instead of reverting")
        negatives[name] = "reverted"
    secs["step"] = time.perf_counter() - t_step
    log(f"phase 6b: MSM host steps [calls, seconds]: {json.dumps(host_since(host0))}")
    digests = {"proof": hashlib.sha256(proof).hexdigest(), "evm_verifier.bin": hashlib.sha256(code).hexdigest()}
    stats.update({
        "k": vk1.k, "instances": len(inst[0]), "proof_bytes": len(proof), "bytecode_bytes": len(code),
        "yul_bytes": yul_bytes, "gas": gas, "negatives": negatives, "sha256": digests, "seconds": secs,
        "peak_device_gib": peak_dev, "checkpoint_bytes": ck_bytes, "disk_free_bytes": free,
        "from_checkpoint": {**kept, "cosets_read": len(from_ck), "cosets": len(cosets)},
        "prove_marks_gib": [[label, round(a, 2), round(p, 2)] for label, a, p in pm.prove_marks()],
        "launches": launches, "k1_by_mode": by_mode, "keygen_launches": kg_launches,
        "resume_launches": res_launches,
    })
    log(f"phase 6b (lowmem, checkpoint, EVM tail): {json.dumps(stats)}")
    for what, got, pinned in (("proof", digests["proof"], EVM_TAIL_PROOF_SHA256),
                              ("evm_verifier.bin", digests["evm_verifier.bin"], EVM_VERIFIER_SHA256),
                              ("gas", gas, EVM_TAIL_GAS)):
        log(f"phase 6b {what}: {got} (pinned {pinned})")
    if digests["proof"] != EVM_TAIL_PROOF_SHA256:
        fail("phase 6b: the Keccak/GWC layer-1 proof's bytes differ from the pinned proof")
    if digests["evm_verifier.bin"] != EVM_VERIFIER_SHA256:
        fail("phase 6b: the verifier's deployment bytecode differs from the pinned bytecode")
    if gas != EVM_TAIL_GAS:
        fail("phase 6b: the EVM verifier's gas differs from the pinned gas")
    clock("phase 6b")
    return stats


def chunk_instance_of(info) -> list[int]:
    """The 9-cell chunk instance of a ChunkInfo, in the order that
    ChunkVerifier's binding check derives it: chain id, prev, post and
    withdraw roots (hi, lo), then the info's data hash (hi, lo)."""
    from scroll_prover_tpu_torch.witness.block import WitnessBlock
    from scroll_prover_tpu_torch.zkevm import chunk_instance

    wb = WitnessBlock(chain_id=info.chain_id, prev_state_root=info.prev_state_root,
                      post_state_root=info.post_state_root, withdraw_root=info.withdraw_root,
                      tx_bytes=info.tx_bytes)
    dh = int(info.data_hash, 16)
    return chunk_instance(wb)[:7] + [dh >> 128, dh & ((1 << 128) - 1)]


def ladder(srs, dev, gen, rows, info, held_k2=frozenset()):
    """Phase 6 (see the module docstring): the inner BenchCircuit proof at
    k = 20 over the chunk instance of `info` (phase 5's ChunkInfo, chain id
    LADDER_CHAIN_ID), then layers 1 and 2 through ChunkProver, verified,
    pinned, wrapped into a ChunkProofV2 that ChunkVerifier accepts; then,
    after the launch counts are read, K2 at every pass of the phase that
    earlier phases did not hold (`held_k2`, note_k2's keys) against its plain
    version. Returns (per-layer stats, the ChunkProofV2, the params map, the
    keys of the K2 passes held so far)."""
    from scroll_prover_tpu_torch.integration.bench_circuit import BenchCircuit
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify
    from scroll_prover_tpu_torch.prover import ChunkProofV2, ChunkProver, ChunkVerifier
    from scroll_prover_tpu_torch.prover.proofs import ChunkProofInner, ProofPayload
    from scroll_prover_tpu_torch.prover.protocol import protocol_from_vk
    from scroll_prover_tpu_torch.prover.provers import _ladder_multiopen

    mo = _ladder_multiopen()
    info = dataclasses.replace(info, chain_id=LADDER_CHAIN_ID)
    k, instance = 20, [chunk_instance_of(info)]
    passes = {}
    out = {}

    def run():
        circ = BenchCircuit(4096)
        t0 = time.perf_counter()
        pk, vk = keygen(srs, k, circ, instance)
        proof = prove(srs, pk, circ, instance, seed=LADDER_SEED, multiopen=mo)
        del pk
        if not verify(srs, vk, instance, proof, multiopen=mo):
            fail("the ladder's inner k=20 proof did not verify")
        torch.cuda.synchronize()
        out["inner_seconds"] = time.perf_counter() - t0
        log(f"ladder inner proof (BenchCircuit(4096), k = {k}, {mo}, {len(instance[0])} instance cells): "
            f"keygen, prove and verify {out['inner_seconds']:.2f} s, {len(proof)} bytes")
        prev = ProofPayload(proof=proof, instances=instance[0],
                            protocol=protocol_from_vk(vk, len(instance[0]), multiopen=mo),
                            vk_id=hex(vk.transcript_repr()))
        prover = ChunkProver(params_map={k: srs}, device=dev)
        p1, vk1, out["layer1"], circ1 = ladder_layer(prover, prev, vk, 1, mo)
        out["evm_tail"] = evm_tail(prover, p1, vk1, circ1, out["layer1"], dev, rows)
        del circ1  # its assignment: layer 2 needs the host memory
        p2, vk2, out["layer2"], _ = ladder_layer(prover, p1, vk1, 2, mo)
        bad = bytearray(p2.proof)
        bad[100] ^= 1
        try:
            rejected = not verify(prover.params_map[vk2.k], vk2, [p2.instances], bytes(bad), multiopen=mo)
        except (AssertionError, ValueError):
            rejected = True
        if not rejected:
            fail("a tampered layer-2 proof verified")
        chunk = ChunkProofV2(ChunkProofInner(layers=[prev, p1, p2], chunk_info_=info))
        t0 = time.perf_counter()
        if not ChunkVerifier(prover.params_map, device=dev).verify_chunk_proof(chunk):
            fail("ChunkVerifier.verify_chunk_proof rejected the chunk proof")
        out["verify_chunk_proof_seconds"] = time.perf_counter() - t0
        log(f"layer 2: tampered proof rejected; ChunkVerifier.verify_chunk_proof True in "
            f"{out['verify_chunk_proof_seconds']:.2f} s")
        return chunk, prover.params_map

    def run_hooked():
        with hooked(("K2",), lambda _key, *a: note_k2(passes, *a)):
            return run()

    t0 = time.perf_counter()
    (chunk, params_map), launches, modes = counted(LADDER_PATH, run_hooked)
    log(f"ladder: {time.perf_counter() - t0:.1f} s; launches: {json.dumps(launches)}; K1 by mode: {json.dumps(modes)}")
    for key, v in launches.items():
        rows[key]["ladder_launches"] = v
    for key, by_mode in modes.items():
        for mode, v in by_mode.items():
            rows[key]["modes"][mode]["ladder_launches"] = v
    for layer, pinned in ((1, LAYER1_PROOF_SHA256), (2, LAYER2_PROOF_SHA256)):
        proof = chunk.inner.layers[layer].proof
        digest = hashlib.sha256(proof).hexdigest()
        log(f"layer {layer} proof: {len(proof)} bytes, sha256 {digest} (pinned {pinned})")
        if digest != pinned:
            fail(f"the layer-{layer} proof's bytes differ from the pinned proof")

    gc.collect()
    torch.cuda.empty_cache()
    log(f"ladder checks: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device memory still held")
    t0 = time.perf_counter()
    # K3, K4 and K5 are held on phase 7's larger shapes (layer 3's densest
    # commit group at 2^23 points, its SRS scalars)
    new = {key: v for key, v in passes.items() if key not in held_k2}
    log(f"ladder: K2 gave {len(passes)} distinct passes, {len(new)} of them not held in earlier phases")
    rows["K2"]["max_abs_err"] = max(rows["K2"]["max_abs_err"], k2_pass_checks(new, dev, gen, "the ladder"))
    log(f"ladder checks: {time.perf_counter() - t0:.1f} s")
    return out, chunk, params_map, frozenset(held_k2) | frozenset(passes)


class _BatchMarks(_Marks):
    """_Marks for phase 7: at each mark also the peak device memory since
    the mark before (the peak is then reset), the launches of BATCH_PATH so
    far, the caching allocator's retries, out-of-memory events, reserved
    and allocated bytes and the script's clock, and in `layer` the layer
    whose keygen and prove are running (3 or 4, from its SRS to its proof;
    None between)."""

    def __init__(self):
        super().__init__()
        self.peaks = []
        self.launches = []
        self.mem = []  # the caching allocator's state at each mark
        self.layer = None

    def emit(self, record):
        super().emit(record)
        msg = record.getMessage()
        self.peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        st = torch.cuda.memory_stats()
        self.mem.append({"retries": st.get("num_alloc_retries", 0), "ooms": st.get("num_ooms", 0),
                         "reserved_gib": st.get("reserved_bytes.all.current", 0) / 2**30,
                         "allocated_gib": st.get("allocated_bytes.all.current", 0) / 2**30,
                         "clock_s": time.perf_counter() - _T_START})
        self.launches.append({key: wrapper(key).launches for key in BATCH_PATH})
        for layer in (3, 4):
            if msg == f"batch: layer{layer} srs ready":
                self.layer = layer
            elif msg == f"batch: layer{layer} proved":
                self.layer = None


def batch_layer_stats(marks, layer: int, gadget: str, first: int) -> tuple[dict, int]:
    """One layer's seconds, rows, k, peak device memory, RSS at its marks
    and launches from phase 7's marks, starting at mark index `first` (the
    layer's recording pass comes first; `gadget` names its builder's
    marks). Returns (stats, the index after the layer's last mark)."""
    msgs = [m for m, _ in marks.marks[first:]]
    end = first + msgs.index(f"batch: layer{layer} proved") + 1
    span = range(first, end)
    times = {}
    for i in span:
        msg, t = marks.marks[i]
        for key in ("circuit:", "srs ready", "keygen done", "proved"):
            if msg.startswith(f"batch: layer{layer} {key}"):
                times[key] = t
                if key == "circuit:":
                    rows_k = msg.split(": ")[-1]
    count, assign = gadget_seconds([marks.marks[i] for i in span], gadget, f"batch layer {layer}")
    secs = {
        "count": count,
        "srs": times["srs ready"] - times["circuit:"],
        "assign": assign,
        "keygen": times["keygen done"] - times["srs ready"] - assign,
        "prove": times["proved"] - times["keygen done"],
    }
    before = marks.launches[first - 1] if first else dict.fromkeys(BATCH_PATH, 0)
    stats = {
        "rows_k": rows_k, "seconds": secs,
        "peak_device_gib": max(marks.peaks[i] for i in span) / 2**30,
        "peak_rss_at_marks_gib": max(marks.rss[i] for i in span),
        "launches": {key: marks.launches[end - 1][key] - before[key] for key in BATCH_PATH},
    }
    return stats, end


def batch(chunk, params_map, dev, gen, rows, held_k2):
    """Phase 7 (see the module docstring): the blob and header of phase 6's
    chunk, layers 3 and 4 through BatchProver's own code, verified, pinned
    and checked by BatchVerifier; then, after the launch counts are read,
    K2 at the passes earlier phases did not hold (`held_k2`), K3 and K4 on a slice of layer
    3's densest commit group and K5 on slices of layer 3's SRS scalars,
    each against its plain version. Returns the phase's stats."""
    from scroll_prover_tpu_torch.aggregator.batch_header import BatchHeader
    from scroll_prover_tpu_torch.integration.prove import get_blob_from_chunks
    from scroll_prover_tpu_torch.native.zstd_codec import zstd_available
    from scroll_prover_tpu_torch.ops import fixed_base as fb
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, check_accumulator, verify
    from scroll_prover_tpu_torch.prover import BatchProver, BatchVerifier
    from scroll_prover_tpu_torch.prover.provers import _L4_DH0, _ladder_multiopen, load_vk
    from scroll_prover_tpu_torch.prover.tasks import BatchProvingTask
    from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS

    mo = _ladder_multiopen()
    info = chunk.inner.chunk_info()
    out = {"seconds": {}}
    passes = {}
    k5_slices = []
    timed = {key: [] for key in ("K2", "K3", "K4")}
    launch_host = {key: [] for key in timed}  # (host seconds inside the wrapper, script clock) per launch
    gcs, gc_at = [], [0.0]
    pending = {}
    k3 = {"rank": (-1, -1), "args": None}
    marks = _BatchMarks()

    hook_s = {"K2 tables to the host": 0.0, "K3 digit counts": 0.0, "all": 0.0}

    def note(key, *a):
        t0 = time.perf_counter()
        note_hooked(key, *a)
        hook_s["all"] += time.perf_counter() - t0

    def note_hooked(key, *a):
        if key == "K2":
            n_before = len(passes)
            note_k2(passes, *a)
            if len(passes) > n_before:  # a new pass: its tables wait on the host (2^26 ones are 4 GiB)
                t0 = time.perf_counter()
                last = next(reversed(passes))
                n_calls, tables = passes[last]
                passes[last] = (n_calls, tuple(None if t is None else t.cpu() for t in tables))
                hook_s["K2 tables to the host"] += time.perf_counter() - t0
        elif key == "K5":
            table, digs = a
            k5_slices.append((table, digs[:, :BATCH_K5_SLICE].clone()))
        if marks.layer == 3 and key in timed:
            w = work(key, *a)
            if key == "K3":  # the digits' count is on the card: read it before the timed launch
                t0 = time.perf_counter()
                pts, digs, signs, B = a
                rank = (digs.shape[0], int(w[1]) // (11 * MULS_PER_MONT))
                if rank > k3["rank"]:
                    k3["rank"] = rank
                    k3["args"] = (pts, digs[:BATCH_K3_ROWS].cpu(), signs[:BATCH_K3_ROWS].cpu(), B, tuple(digs.shape))
                    k3["take_k4"] = True
                hook_s["K3 digit counts"] += time.perf_counter() - t0
            elif key == "K4" and k3.pop("take_k4", False):  # that group's slot table, whole (tens of MiB)
                k3["k4_in"] = a[0].clone()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            pending[key] = (start, w, time.perf_counter())

    def done(key):
        t0 = time.perf_counter()
        done_hooked(key)
        hook_s["all"] += time.perf_counter() - t0

    def done_hooked(key):
        if key in pending:
            start, w, host_t0 = pending.pop(key)
            launch_host[key].append((time.perf_counter() - host_t0, host_t0 - _T_START))
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            timed[key].append((start, end, w))

    def on_gc(phase, info):  # each collection's host seconds, to tell a collector pause from a device wait
        if phase == "start":
            gc_at[0] = time.perf_counter()
        else:
            gcs.append((time.perf_counter() - gc_at[0], info["generation"], gc_at[0] - _T_START, marks.layer))

    def step(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        log(f"batch {name}: {out['seconds'][name]:.2f} s")
        return res

    def run():
        blob = step("blob", lambda: get_blob_from_chunks([info]))
        log(f"batch blob: zstd_available() {zstd_available()}, envelope byte 0x{blob[0]:02x}, {len(blob)} bytes "
            f"({len(info.tx_bytes)} transaction bytes of one chunk)")
        header = step("header", lambda: BatchHeader.construct_from_chunks(
            4, 0, 0, 0, b"\0" * 32, 1_700_000_000, [info], blob))
        log(f"batch header: batch hash 0x{header.batch_hash().hex()}, blob versioned hash "
            f"0x{header.blob_versioned_hash.hex()}")
        task = BatchProvingTask([chunk], header, blob)
        prover = BatchProver(params_map, device=dev)
        with prover_marks("scroll_prover_tpu_torch", "batch prove", marks), hooked(("K2", "K3", "K4", "K5"), note, done):
            proof = step("prove", lambda: prover._gen_batch_proof(task, seed=BATCH_SEED))
        del prover
        return proof

    before = {key: wrapper(key).launches for key in KERNELS}
    t0 = time.perf_counter()
    gc.callbacks.append(on_gc)
    try:
        proof, launches, modes = counted(BATCH_PATH, run)
    finally:
        gc.callbacks.remove(on_gc)
    out["seconds"]["phase"] = time.perf_counter() - t0
    for key in KERNELS:
        rows[key]["batch_launches"] = launches[key] if key in launches else wrapper(key).launches - before[key]
    for key, by_mode in modes.items():
        for mode, v in by_mode.items():
            rows[key]["modes"][mode]["batch_launches"] = v
    log(f"batch: {out['seconds']['phase']:.1f} s; launches: {json.dumps(launches)}; K1 by mode: {json.dumps(modes)}")
    out["hook_seconds"] = hook_s
    log(f"batch: host seconds inside the phase's kernel hooks (inside its layers' seconds below): "
        f"{json.dumps(hook_s)}")
    for layer in (3, 4):  # the prover's phases and cosets, from its marks
        start = next(t for msg, t in marks.marks if msg == f"batch: layer{layer} keygen done")
        end = next(t for msg, t in marks.marks if msg == f"batch: layer{layer} proved")
        prev, mem_prev = start, None
        for (msg, t), mem in zip(marks.marks, marks.mem):
            if start < t <= end and (msg.startswith("prove[") or msg.startswith("quotient coset") and msg.endswith(" done")):
                label = msg[len("prove["):msg.index("]")] if msg.startswith("prove[") else msg.removesuffix(" done")
                alloc = "" if mem_prev is None else (
                    f"; allocator: retries +{mem['retries'] - mem_prev['retries']}, out-of-memory "
                    f"+{mem['ooms'] - mem_prev['ooms']}, reserved {mem['reserved_gib']:.2f} GiB, allocated "
                    f"{mem['allocated_gib']:.2f} GiB, at {mem['clock_s']:.1f} s")
                log(f"batch layer {layer} prove: {label}: {t - prev:.2f} s{alloc}")
                prev = t
            if start <= t <= end:
                mem_prev = mem
    slow = sorted(g for g in gcs if g[0] > 0.5)
    log(f"batch: {len(gcs)} garbage collections, {sum(g[0] for g in gcs):.2f} s in all; over 0.5 s [seconds, "
        f"generation, at, layer]: {json.dumps(slow[-8:])}")
    for key, calls in launch_host.items():
        worst = sorted(calls)[-3:]
        log(f"batch: {key} launches on layer 3's keygen and prove, host seconds inside the wrapper: "
            f"{sum(c[0] for c in calls):.2f} s in all; the longest [seconds, at]: {json.dumps(worst)}")

    l3, l4 = proof.inner.layers
    first = 0
    for layer, payload, gadget in ((3, l3, "aggregation-gadget"), (4, l4, "verifier-gadget")):
        stats, first = batch_layer_stats(marks, layer, gadget, first)
        vk = load_vk(payload.vk_id)
        srs = params_map[vk.k]
        t1 = time.perf_counter()
        if not verify(srs, vk, [payload.instances], payload.proof, multiopen=mo):
            fail(f"the batch's layer-{layer} proof did not verify")
        stats["seconds"]["verify"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        if not check_accumulator(srs, *acc_from_limbs(payload.instances[:ACC_CELLS])):
            fail(f"the batch's layer-{layer} accumulator fails its pairing")
        stats["seconds"]["accumulator"] = time.perf_counter() - t1
        cs = vk.cs
        stats.update({
            "k": vk.k, "advice": cs.num_advice, "fixed": cs.num_fixed, "lookups": len(cs.lookups),
            "gates": len(cs.gates), "permutation": len(cs.perm_columns), "extended_k": vk.domain.extended_k,
            "instances": len(payload.instances), "proof_bytes": len(payload.proof),
        })
        out[f"layer{layer}"] = stats
        log(f"batch layer {layer}: {json.dumps(stats)}")
    log(f"batch: process peak host RSS {rss_gib():.2f} GiB")

    verifier = BatchVerifier(params_map, device=dev)

    def verdict(p):
        try:
            return verifier.verify_batch_proof(p)
        except (AssertionError, ValueError):
            return False

    t1 = time.perf_counter()
    if not verdict(proof):
        fail("BatchVerifier.verify_batch_proof rejected the batch proof")
    out["seconds"]["verify_batch_proof"] = time.perf_counter() - t1
    blob = proof.inner.blob_bytes
    bad_blob = bytearray(blob)
    bad_blob[len(blob) // 2] ^= 1
    proof.inner.blob_bytes = bytes(bad_blob)
    if verdict(proof):
        fail("a batch proof with one blob byte flipped verified")
    proof.inner.blob_bytes = blob
    bad = bytearray(l4.proof)
    bad[100] ^= 1
    proof.inner.layers[1] = dataclasses.replace(l4, proof=bytes(bad))
    if verdict(proof):
        fail("a batch proof with one byte of layer 4's proof flipped verified")
    proof.inner.layers[1] = l4
    dh = int(info.data_hash, 16)
    if l3.instances[_L4_DH0:_L4_DH0 + 2] != [dh >> 128, dh & ((1 << 128) - 1)]:
        fail("layer 3's exposed data-hash cells differ from the chunk's data hash")
    log(f"batch: verify_batch_proof True in {out['seconds']['verify_batch_proof']:.2f} s; a flipped blob byte and "
        f"a flipped layer-4 proof byte rejected; exposed data hash == the chunk's")
    envelope = proof.inner.blob_bytes[0]
    if envelope not in BATCH_LAYER3_PROOF_SHA256:
        fail(f"the blob's envelope byte 0x{envelope:02x} has no pinned batch proofs")
    for layer, payload, pins in ((3, l3, BATCH_LAYER3_PROOF_SHA256), (4, l4, BATCH_LAYER4_PROOF_SHA256)):
        pinned = pins[envelope]
        digest = hashlib.sha256(payload.proof).hexdigest()
        log(f"batch layer {layer} proof: {len(payload.proof)} bytes, sha256 {digest} (pinned {pinned})")
        if digest != pinned:
            fail(f"the batch's layer-{layer} proof's bytes differ from the pinned proof")
    del proof

    # per-launch time on layer 3's keygen and prove beside the summed bound
    torch.cuda.synchronize()
    for key, calls in timed.items():
        ms = sum(s.elapsed_time(e) for s, e, _ in calls)
        b = sum(bound(*w)[0] for _, _, w in calls)
        n = max(len(calls), 1)
        out[f"{key}_layer3"] = {"calls": len(calls), "ms_per_call": ms / n, "bound_ms_per_call": b / n}
        log(f"{key} on layer 3's keygen and prove: {len(calls)} calls, {ms / n:.4f} ms per call by CUDA events, "
            f"bound {b / n:.4f} ms per call, {100 * b / max(ms, 1e-9):.1f}% of bound")
    del timed

    gc.collect()
    torch.cuda.empty_cache()
    log(f"batch checks: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device memory still held")
    t0 = time.perf_counter()
    errs = {}
    pts, digs, signs, B, full = k3["args"]
    digs, signs = digs.to(dev), signs.to(dev)
    k3_ms, raw = event_ms(lambda: mt._accum_k3(pts, digs, signs, B), 3)
    b3 = bound(*work("K3", pts, digs, signs, B))
    p_ms, plain = wall_ms(lambda: mt._accum_v2_plain(pts, digs, signs, B))
    errs["K3"] = max_abs_err(raw, plain)
    log(f"K3 on {tuple(digs.shape)} of layer 3's densest commit group {full} ({k3['rank'][1]} non-zero digits in "
        f"the group): {k3_ms:.3f} ms by CUDA events, bound {b3[0]:.3f} ms ({b3[1]}); vs plain version "
        f"({p_ms / 1e3:.1f} s wall): max_abs_err {errs['K3']}")
    del plain, pts, digs, signs, raw
    k4 = k4_check(k3.pop("k4_in"), "layer 3's densest commit group")
    errs["K4"] = k4["max_abs_err"]
    rows["K4"]["reductions"]["layer 3"] = k4
    new = {key: v for key, v in passes.items() if key not in held_k2}
    log(f"batch: K2 gave {len(passes)} distinct passes, {len(new)} of them not held in earlier phases")
    errs["K2"] = k2_pass_checks(new, dev, gen, "the batch")
    worst = 0
    for table, digs in k5_slices:
        k5_ms, got = event_ms(lambda: torch.stack(list(fb._accumulate_k5(table, digs))), 3)
        err = max_abs_err(got, torch.stack(list(fb._accumulate_plain(table, digs))))
        b5 = bound(*work("K5", table, digs))
        log(f"K5 on a slice of layer 3's SRS scalars {tuple(digs.shape)}: {k5_ms:.4f} ms by CUDA events, "
            f"bound {b5[0]:.4f} ms ({b5[1]}); vs plain version: max_abs_err {err}")
        worst = max(worst, err)
    if not k5_slices:
        fail("K5 never ran in phase 7")
    errs["K5"] = worst
    for key, err in errs.items():
        if err != 0:
            fail(f"{key} disagrees with its plain version at phase 7's shapes")
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
    out["seconds"]["checks"] = time.perf_counter() - t0
    log(f"batch checks: {out['seconds']['checks']:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-main", action="store_true", help="stop after the kernel checks")
    ap.add_argument("--levels-only", action="store_true",
                    help="build, then only K7/K8 at every level and FastDomain(20)'s device times")
    ap.add_argument("--profile", metavar="DIR", help="profile two more k=20 proves, tables into DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from scroll_prover_tpu_torch.device import resolve_device

    dev = resolve_device("cuda:0")  # the package's own allocator settings come with it
    torch.cuda.set_device(dev)
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from scroll_prover_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    host_step_hook()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} (parallel nvcc)")
    for name, text in sorted(cuda_lib.BUILD_LOG.items()):
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    if args.levels_only:  # also runs on a tree from before the per-level tables, to compare in one call
        levels = {key: k78_row(lv) for key, lv in k78_levels(dev, gen).items()}
        print(json.dumps({"levels": levels, "fast_domain_ms": fast_domain_times(dev, gen)}))
        return
    t0 = time.perf_counter()
    rows = check_kernels(dev, gen)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    clock("phases 1-2")

    launches = {key: None for key in KERNELS}
    if not args.skip_main:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k2_main = {}

        def main_run():
            with hooked(("K2",), lambda _key, *a: note_k2(k2_main, *a)):
                return main_path(dev)

        (secs, prove_again, proof, srs, verify_proof), main_launches, by_mode = counted(MAIN_PATH, main_run)
        launches.update(main_launches)
        for key, modes in by_mode.items():
            for mode, v in modes.items():
                rows[key]["modes"][mode]["launches"] = v
        peak_dev = torch.cuda.max_memory_allocated()
        rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log(f"main path seconds: {json.dumps(secs)}")
        log(f"main path peak device memory {peak_dev / 2**30:.2f} GiB; peak host RSS {rss_kib / 2**20:.2f} GiB")
        log(f"main path launches: {json.dumps(main_launches)}; K1 by mode: {json.dumps(by_mode)}")
        rows["K2"]["max_abs_err"] = max(rows["K2"]["max_abs_err"], k2_pass_checks(k2_main, dev, gen, "phase 3"))
        held_k2 = frozenset(k2_main)  # K2 passes held so far: later phases hold only new ones
        del k2_main
        clock("phase 3")

        t0 = time.perf_counter()
        cols, alt_launches, _ = counted(ALT_PATH, lambda: alt_engines(dev, gen, srs))
        launches.update(alt_launches)
        log(f"phase 4: {time.perf_counter() - t0:.1f} s; launches: {json.dumps(alt_launches)}")
        err6 = v1_breakdown(srs.dev_powers(), cols)
        rows["K6"]["max_abs_err"] = max(rows["K6"]["max_abs_err"], err6)
        err3 = k3_full_check(srs.dev_powers(), cols)
        rows["K3"]["max_abs_err"] = max(rows["K3"]["max_abs_err"], err3)
        if args.profile:  # the profiled prove's launches and device time, by K1 mode too
            for label, st in profile_prove(prove_again, proof, args.profile).items():
                key, _, mode = label.partition(" ")
                target = rows[key]["modes"][mode] if mode else rows[key]
                target.update({"prove_launches": st["launches"], "prove_device_ms": st["device_ms"]})
        clock("phase 4")

        mesh_launches, mesh_modes, mesh_k2 = mesh_phase(dev, gen, srs, cols, prove_again, verify_proof, held_k2)
        for key, v in mesh_launches.items():
            rows[key]["mesh_launches"] = v
        for key, modes in mesh_modes.items():
            for mode, v in modes.items():
                rows[key]["modes"][mode]["mesh_launches"] = v
        held_k2 |= mesh_k2
        del prove_again, verify_proof, cols
        clock("phase 4b")

        # the phase runs at the package's defaults: no cap or degree knob
        for knob in [v for v in os.environ if v.startswith("SPT_")]:
            log(f"chunk: ignoring {knob}={os.environ.pop(knob)}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rss0 = rss_gib()
        t0 = time.perf_counter()
        def chunk_run():
            with path_inputs() as seen:
                return chunk_proof(dev), seen

        from scroll_prover_tpu_torch import trace as port_trace

        port_trace.drain()
        port_trace.enable(True)  # the phase's frontend, keygen and prove as the port's spans
        try:
            ((secs, chunk_again, chunk, info), seen), chunk_launches, chunk_modes = counted(CHUNK_PATH, chunk_run)
        finally:
            port_trace.enable(False)
        log_spans("chunk:", port_trace.drain())
        for key, v in chunk_launches.items():
            rows[key]["chunk_launches"] = v
        for key, modes in chunk_modes.items():
            for mode, v in modes.items():
                rows[key]["modes"][mode]["chunk_launches"] = v
        peak_dev = torch.cuda.max_memory_allocated()
        log(f"chunk seconds: {json.dumps(secs)}; phase {time.perf_counter() - t0:.1f} s")
        log(f"chunk peak device memory {peak_dev / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; "
            f"peak host RSS {rss_gib():.2f} GiB (before the phase {rss0:.2f})")
        log(f"chunk launches: {json.dumps(chunk_launches)}; K1 by mode: {json.dumps(chunk_modes)}")
        for key, err in chunk_kernel_checks(seen, dev, gen).items():
            rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
        rows["K4"]["reductions"]["the chunk"] = seen["k4"]
        held_k2 |= frozenset(seen["k2"])
        del seen
        if args.profile:  # two more chunk proves, profiled, after the counts are read
            for label, st in profile_prove(chunk_again, chunk, args.profile, tag="chunk_prove").items():
                key, _, mode = label.partition(" ")
                target = rows[key]["modes"][mode] if mode else rows[key]
                target.update({"chunk_device_ms": st["device_ms"],
                               "chunk_bound_ms_per_launch": st["bound_ms_per_launch"]})
        del chunk_again, chunk
        clock("phase 5")

        # phase 6 at the package's defaults too, on a card freed of phase 5
        for knob in [v for v in os.environ if v.startswith("SPT_")]:
            log(f"ladder: ignoring {knob}={os.environ.pop(knob)}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"ladder: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device memory held from earlier phases")
        _stats, chunk, params_map, held_k2 = ladder(srs, dev, gen, rows, info, held_k2)
        clock("phase 6")

        # phase 7 at the package's defaults, on a card freed of phase 6's
        # prover (its keygen cache and its circuits' assignments went with
        # it); the chunk proof, the vk registry and the params map stay
        # (layer 4 reuses its 2^22 SRS)
        for knob in [v for v in os.environ if v.startswith("SPT_")]:
            log(f"batch: ignoring {knob}={os.environ.pop(knob)}")
        del srs
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"batch: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device memory held from earlier phases; "
            f"host RSS {proc_status_gib('VmRSS'):.2f} GiB")
        batch(chunk, params_map, dev, gen, rows, held_k2)
        clock("phase 7")

    kernels = []
    for key, (_mod, _fn, _cnames, src, rep) in KERNELS.items():
        kernels.append({
            "name": kernel_name(key), "route": "cuda", "source": f"scroll_prover_tpu_torch/csrc/{src}",
            "replaces": f"scroll_prover_tpu/ops/{rep}", "launches": launches[key], **rows[key],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    leave(0)
