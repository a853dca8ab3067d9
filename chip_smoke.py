"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py              # everything below, on cuda:0
    python3 chip_smoke.py --skip-main  # phases 1-2 only (build + kernel checks)
    python3 chip_smoke.py --profile DIR  # also profile two more k=20 proves:
                                         # torch.profiler (device time by kernel,
                                         # device busy share) and cProfile (host);
                                         # summaries printed, full tables in DIR

Phases, each fatal on failure (non-zero exit, no ok line):
  1. device and build: require CUDA, print the card's name and power limit,
     build the CUDA kernels (csrc/*.cu) from this checkout in parallel;
  2. each kernel (K1-K5) against its plain PyTorch version on the card, exact
     equality (integer arithmetic: tolerance 0), at the main path's shapes,
     timed with CUDA events in turns (plain, kernel, kernel, plain); the MSM
     is also checked against host Pippenger;
  3. the main path at full size: SRS.generate_fast(20), keygen of
     BenchCircuit (4096 rows) at k = 20, prove, verify (must be True), with
     every kernel's launch count taken over this phase alone (each must be
     > 0), peak device memory and peak host RSS;
  4. a `kernels` JSON line, the nvidia-smi line, and as the last line
     {"ok": true, "device": {...}}.

It imports torch and the port (scroll_prover_tpu_torch) only.
"""
from __future__ import annotations

import argparse
import json
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

REPLACES = {
    "K1": ("scroll_prover_tpu_torch/csrc/mont_mul.cu", "scroll_prover_tpu/ops/ntt_tile.py:184"),
    "K2": ("scroll_prover_tpu_torch/csrc/ntt.cu", "scroll_prover_tpu/ops/ntt_tile.py:126"),
    "K3": ("scroll_prover_tpu_torch/csrc/msm.cu", "scroll_prover_tpu/ops/msm_tile.py:531"),
    "K4": ("scroll_prover_tpu_torch/csrc/msm.cu", "scroll_prover_tpu/ops/msm_tile.py:608"),
    "K5": ("scroll_prover_tpu_torch/csrc/fixed_base.cu", "scroll_prover_tpu/ops/fixed_base.py:119"),
}
NAMES = {"K1": "mont_mul", "K2": "bntt", "K3": "msm_accum", "K4": "msm_lane_reduce", "K5": "fixed_base"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_turns(kernel, plain, reps: int):
    """CUDA-event times in ms, in turns plain, kernel, kernel, plain (after a
    warm-up of each). Returns (kernel_ms, plain_ms, kernel_out, plain_out)."""
    def timed(fn, n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            out = fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n, out

    k_out = kernel()
    p_out = plain()
    torch.cuda.synchronize()
    p1, _ = timed(plain, 1)
    k1, _ = timed(kernel, reps)
    k2, _ = timed(kernel, reps)
    p2, _ = timed(plain, 1)
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


def bound(bytes_moved: float, muls: float):
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, muls / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(dev, gen):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    from scroll_prover_tpu_torch.curves.bn254_curve import g1_generator, host_msm_jac
    from scroll_prover_tpu_torch.fields.limbs import FQ_LIMB, FR_LIMB, limbs_from_torch, limbs_to_ints
    from scroll_prover_tpu_torch.ops import field_ops as fo
    from scroll_prover_tpu_torch.ops import fixed_base as fb
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.ops import ntt_tile as nt
    from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain

    rows = {}

    def record(key, k_ms, p_ms, err, b):
        rows[key] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1]}
        log(f"{key} {NAMES[key]}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}), max_abs_err {err}")
        if err != 0:
            fail(f"{key} disagrees with its plain version")

    # K1: 2^23 rows of Fr (the n^-1 / coset scale of the 2^23 quotient); the
    # main path's other operand layouts at 2^23 (limb-major planes of the
    # four-step twiddle multiply, a (16,) scalar broadcast over a column with
    # element stride 0); and a Fq batch. Each must match exactly; the row's
    # max_abs_err is the largest over all four.
    n = 1 << 23
    a, b = rand_field(FR_LIMB, n, gen, dev), rand_field(FR_LIMB, n, gen, dev)
    k_ms, p_ms, ko, po = time_turns(
        lambda: fo.mont_mul_k1(FR_LIMB, a, b), lambda: fo._mont_mul_plain(FR_LIMB, a, b), 20)
    errs = {"row-major 2^23": max_abs_err(ko, po)}
    del ko, po
    al, bl = a.T.contiguous(), b.T.contiguous()  # (16, 2^23) planes
    errs["limb-major 2^23"] = max_abs_err(
        fo.mont_mul_k1(FR_LIMB, al, bl, limb_axis=0), nt._lm_mul_plain(al, bl))
    del al, bl
    s = rand_field(FR_LIMB, 1, gen, dev)[0]  # (16,)
    errs["scalar broadcast 2^23"] = max_abs_err(
        fo.mont_mul_k1(FR_LIMB, a, s), fo._mont_mul_plain(FR_LIMB, a, s))
    nq = 1 << 20
    aq, bq = rand_field(FQ_LIMB, nq, gen, dev), rand_field(FQ_LIMB, nq, gen, dev)
    errs["Fq 2^20"] = max_abs_err(fo.mont_mul_k1(FQ_LIMB, aq, bq), fo._mont_mul_plain(FQ_LIMB, aq, bq))
    log(f"K1 max_abs_err by operand layout: {json.dumps(errs)}")
    record("K1", k_ms, p_ms, max(errs.values()), bound(3 * 64 * n, MULS_PER_MONT * n))
    del a, b, aq, bq

    # K2: one level of the 2^23 four-step, 2^15 rows x 256
    w8 = EvaluationDomain(8).omega
    tw = nt._twpack(w8, 8, dev)
    v = rand_field(FR_LIMB, 1 << 23, gen, dev).T.contiguous().reshape(16, 1 << 15, 256)
    k_ms, p_ms, ko, po = time_turns(
        lambda: nt._bntt_k2(v, tw, 8), lambda: nt._bntt_plain(v, tw, 8), 10)
    muls = MULS_PER_MONT * (1 << 23) * 8 // 2
    record("K2", k_ms, p_ms, max_abs_err(ko, po), bound(2 * 64 * (1 << 23) + tw.numel() * 4, muls))
    del v, ko, po

    # points for the MSM: K5 on random scalars (K5 itself is checked below)
    npts, cols = 1 << 16, 2
    s_pts = rand_field(FR_LIMB, npts, gen, dev)
    pts = fb.fixed_base_mul_dev(g1_generator(), s_pts)
    scal = [rand_field(FR_LIMB, npts, gen, dev) for _ in range(cols)]
    scal[0][:7] = 0  # zero scalars land in no bucket
    W, B = mt._wb(mt.MSM_C)
    px, py = mt._msm_prep_points(pts)
    prepped = [mt._msm_prep_digits(s, mt.MSM_C) for s in scal]
    digs = torch.cat([d for d, _ in prepped])
    signs = torch.cat([s for _, s in prepped])
    S, _P = mt._slices(npts)
    CW = digs.shape[0]
    live = int((digs != 0).sum().item())

    # K3
    k_ms, p_ms, k3o, p3o = time_turns(
        lambda: mt._accum_k3(px, py, digs, signs, B),
        lambda: mt._accum_v2_plain(px, py, digs, signs, B), 3)
    out_bytes = CW * S * (B - 1) * 96
    record("K3", k_ms, p_ms, max_abs_err(k3o, p3o),
           bound(2 * 64 * npts + 2 * 4 * CW * npts + out_bytes, live * 11 * MULS_PER_MONT))
    # K4 on K3's output
    k_ms, p_ms, ko, po = time_turns(
        lambda: mt._lane_reduce_k4(k3o), lambda: mt._lane_reduce_plain(k3o), 3)
    adds = CW * (S - 1) * (B - 1)
    record("K4", k_ms, p_ms, max_abs_err(ko, po),
           bound(out_bytes + CW * (B - 1) * 96, adds * 12 * MULS_PER_MONT))
    del k3o, p3o, ko, po

    # the whole MSM against host Pippenger at 2^10 points
    m = 1 << 10
    host_pts_flat = limbs_to_ints(limbs_from_torch(fo.from_mont(FQ_LIMB, pts[:m].reshape(2 * m, 16))))
    host_pts = list(zip(host_pts_flat[0::2], host_pts_flat[1::2]))
    for s in scal:
        want = host_msm_jac(host_pts, limbs_to_ints(limbs_from_torch(s[:m])))
        got = mt.msm_v2_host(pts[:m], s[:m])
        if got != want:
            fail("K3/K4 MSM disagrees with host Pippenger")
    log("K3/K4 MSM at 2^10 points == host_msm_jac")

    # K5 at 2^16 scalars
    table = fb._table_for(g1_generator(), dev)
    sc = rand_field(FR_LIMB, npts, gen, dev)
    sc[:3] = 0
    d5 = fb._digits(sc)
    k_ms, p_ms, ko, po = time_turns(
        lambda: torch.stack(list(fb._accumulate_k5(table, d5))),
        lambda: torch.stack(list(fb._accumulate_plain(table, d5))), 5)
    nz = int((d5 != 0).sum().item())
    record("K5", k_ms, p_ms, max_abs_err(ko, po),
           bound(table.numel() * 4 + d5.numel() * 4 + 3 * 64 * npts, nz * 11 * MULS_PER_MONT))
    return rows


def main_path(dev):
    """Phase 3: generate_fast(20), keygen, prove, verify of BenchCircuit.
    Returns the phase seconds, a closure that proves again, and the proof."""
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
    return secs, lambda: prove(srs, pk, circ, instance, seed=b"chip-smoke"), proof


def profile_prove(run, proof, out_dir: str):
    """Two more proves, each checked against the first: one under
    torch.profiler (device kernel time; busy share = summed device time over
    the prove's wall time), one under cProfile (host time by function)."""
    import cProfile
    import io
    import os
    import pstats

    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        again = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if again != proof:
        fail("profiled prove gave other bytes")
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again
    on_dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_dev:
        fail("torch.profiler recorded no device events")
    busy = sum(dev_us(e) for e in on_dev) / 1e6
    top = sorted(on_dev, key=dev_us, reverse=True)[:15]
    with open(os.path.join(out_dir, "prove_device_profile.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    log(f"profile: prove wall {wall:.2f} s under torch.profiler, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in top:
        log(f"  device {dev_us(e) / 1e3:10.1f} ms  x{e.count:<6d} {e.key[:90]}")

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    again = run()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    if again != proof:
        fail("profiled prove gave other bytes")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(40)
    with open(os.path.join(out_dir, "prove_host_profile.txt"), "w") as fh:
        fh.write(buf.getvalue())
    log(f"profile: prove wall {wall:.2f} s under cProfile; top host functions by own time:")
    stats = pstats.Stats(pr).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    for (fn, line, name), (_cc, nc, tt, ct, _callers) in rows:
        log(f"  host {tt:8.3f} s own {ct:8.3f} s cum x{nc:<8d} {os.path.basename(fn)}:{line} {name}")


def kernel_counters():
    from scroll_prover_tpu_torch.ops import field_ops as fo
    from scroll_prover_tpu_torch.ops import fixed_base as fb
    from scroll_prover_tpu_torch.ops import msm_tile as mt
    from scroll_prover_tpu_torch.ops import ntt_tile as nt

    return {"K1": fo.mont_mul_k1, "K2": nt._bntt_k2, "K3": mt._accum_k3,
            "K4": mt._lane_reduce_k4, "K5": fb._accumulate_k5}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-main", action="store_true", help="stop after the kernel checks")
    ap.add_argument("--profile", metavar="DIR", help="profile two more k=20 proves, tables into DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from scroll_prover_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} (parallel nvcc)")
    for name, text in sorted(cuda_lib.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    t0 = time.perf_counter()
    rows = check_kernels(dev, gen)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    counters = kernel_counters()
    launches = {key: None for key in counters}
    if not args.skip_main:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        secs, prove_again, proof = main_path(dev)
        launches = {key: fn.launches for key, fn in counters.items()}
        peak_dev = torch.cuda.max_memory_allocated()
        rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log(f"main path seconds: {json.dumps(secs)}")
        log(f"main path peak device memory {peak_dev / 2**30:.2f} GiB; peak host RSS {rss_kib / 2**20:.2f} GiB")
        log(f"main path launches: {json.dumps(launches)}")
        missing = [key for key, v in launches.items() if not v]
        if missing:
            fail(f"the main path never launched {missing}")
        if args.profile:
            profile_prove(prove_again, proof, args.profile)

    kernels = []
    for key in ("K1", "K2", "K3", "K4", "K5"):
        src, rep = REPLACES[key]
        kernels.append({
            "name": f"{key} {NAMES[key]}", "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], **rows[key], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
