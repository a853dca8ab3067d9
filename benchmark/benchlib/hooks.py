"""Hooks around the port's NTT entry (`TiledDomain._transform`, every
transform of every domain), its MSM entry (`msm_tile.msm_v2_host_batch`,
every device commit) and its proof's opening (`prover.prove`, the
quotient's chunks from `prover._build_quotient`, the SHPLONK opening
`multiopen.shplonk_open` and the transcript's points), installed from the
benchmark's own files: the program is not edited.

While a prove runs, the hooks count the NTT and MSM calls; on the calls
that the seed picks, they copy one column's input and output to the host.
Of every proof in the window they copy what its opening holds: each opened
polynomial, its points and claimed values, the challenges v and u, the
quotient's chunks, SHPLONK's h and W polynomials with their points, the
points the transcript took and the key's commitments. The reference
checks all of it after the window. In a traced run they also put a
profiler range around each NTT and MSM call ("bench.ntt", "bench.msm") and
count the algorithm's work from the call's shapes and scalars. Every copy
and count the benchmark makes inside the window runs under
`Tracer.tally`, so that the readings leave it out.

`faults` plants faults under the timed path, for the control runs and the
tests: "msm" turns every commitment's point into its negation and
"instance" alters a public cell where it is made (answers altered where
they are produced), "ntt" zeroes the second half of each transform's
input (half the batch left out), "eval" flips a bit of a proof's first
evaluation where it is computed (an advice column's), and "stale" hands back the previous proof
in place of a new one (a step that returns its state unchanged).
"""
from __future__ import annotations

import contextlib

import numpy as np
from benchref.field import Q

from . import roofline, traffic

# transforms the reference can check within its time, split over its
# worker processes: inverse ones (one Horner over the outputs) and forward
# ones (barycentric weights, about 5n products) up to 2^22
NTT_INVERSE_MAX = 1 << 22
NTT_FORWARD_MAX = 1 << 22
FAULTS = ("ntt", "msm", "instance", "eval", "stale")


def _host(t):
    """A host copy (on the CPU too, where .cpu() would share the memory)."""
    return t.detach().to("cpu", copy=True).numpy()


def _limbs(t):
    """A host copy of a (rows, 16) limb column, unpacking (rows, 8) words."""
    if t.shape[-1] == 8:
        w = t.detach().to("cpu", copy=True).numpy().astype(np.uint32)
        out = np.empty(w.shape[:-1] + (16,), dtype=np.uint32)
        out[..., 0::2], out[..., 1::2] = w & 0xFFFF, w >> 16
        return out
    return _host(t)


class _KeepLazy:
    """A lazy coefficient column whose value the opening hook copies the
    first time the opening makes it."""

    __slots__ = ("obj", "keep")

    def __init__(self, obj, keep):
        self.obj, self.keep = obj, keep

    def get(self):
        t = self.obj.get()
        self.keep(t)
        return t


class _Transcript:
    """The prover's transcript, with the opening's challenge u noted."""

    def __init__(self, tr, rec):
        self._tr, self._rec = tr, rec

    def squeeze_challenge(self):
        self._rec["u"] = self._tr.squeeze_challenge()
        return self._rec["u"]

    def __getattr__(self, name):
        return getattr(self._tr, name)


def in_ntt_population(n: int, inverse: bool) -> bool:
    return n <= (NTT_INVERSE_MAX if inverse else NTT_FORWARD_MAX)


class Hooks:
    def __init__(self, tracer, seed: int, per_task: dict, tally: bool, faults=()):
        self.tracer = tracer
        self.seed = seed
        self.per_task = per_task  # {"ntt": k, "msm": k}: samples a task
        self.tally = tally
        self.faults = set(faults)
        self.proofs: list[dict] = []  # one record a proof of the window
        self._proof = None  # the record of the proof being made
        self.outside = 0  # NTT calls of a prove outside the sampled population
        self._last = None  # the last proof made ("stale")
        self.bases: dict[int, tuple[str, int]] = {}  # data_ptr -> (basis, its domain size)
        self.proving = False  # population: calls inside a prove
        self.counts = {"ntt": 0, "msm": 0}
        self.plan = None  # population calls per task, from the warm-up
        self.want = {"ntt": set(), "msm": set()}
        self.rng = None
        self.samples = {"ntt": [], "msm": []}
        self.work = {"ntt": [], "msm": []}  # (bytes, multiplies) per call, traced runs
        self._saved = []

    def register_srs(self, srs) -> None:
        self.bases[srs.dev_powers().data_ptr()] = ("monomial", srs.n)
        self.bases[srs.dev_lagrange().data_ptr()] = ("lagrange", srs.n)

    def start_task(self, index: int) -> None:
        """Task `index` of the window (the warm-up passes None: it counts,
        and samples nothing)."""
        self.counts = {"ntt": 0, "msm": 0}
        self.want = {"ntt": set(), "msm": set()}
        if index is None or self.plan is None:
            self.rng = None
            return
        self.rng = traffic.task_rng(self.seed, index, "sample")
        for kind, k in self.per_task.items():
            total = self.plan[kind]
            self.want[kind] = set(self.rng.sample(range(total), min(k, total)))

    def end_warmup(self) -> None:
        self.plan = dict(self.counts)

    @contextlib.contextmanager
    def prove(self):
        self.proving = True
        try:
            yield
        finally:
            self.proving = False

    def _take(self, kind: str, eligible: bool) -> bool:
        if not self.proving:
            return False
        if not eligible:
            self.outside += 1
            return False
        i = self.counts[kind]
        self.counts[kind] += 1
        return self.rng is not None and i in self.want[kind]

    # --- the NTT entry ------------------------------------------------------

    def _transform(self, orig, dom, x, inverse, scale):
        cols, n = x.shape[0], x.shape[1]
        sample = self._take("ntt", in_ntt_population(n, inverse))
        if sample:
            with self.tracer.tally():
                col = self.rng.randrange(cols)
                rec = {"n": n, "inverse": bool(inverse), "position": self.rng.randrange(n),
                       "inp": _host(x[col]), "scale": None if scale is None else _host(scale)}
        if self.tally:
            self.work["ntt"].append(roofline.ntt_work(cols, n, scale is not None, bool(inverse)))
        if "ntt" in self.faults:
            x = x.clone()
            x[:, n // 2:] = 0
        with self.tracer.range("ntt"):
            out = orig(dom, x, inverse, scale)
        if sample:
            with self.tracer.tally():
                rec["out"] = _host(out[col])
            self.samples["ntt"].append(rec)
        return out

    # --- the MSM entry ------------------------------------------------------

    def _msm(self, orig, points, scalars):
        scalars = list(scalars)
        sample = self._take("msm", True)
        if sample:
            with self.tracer.tally():
                col = self.rng.randrange(len(scalars))
                basis, basis_n = self.bases.get(points.data_ptr(), ("unknown", 0))
                rec = {"basis": basis, "basis_n": basis_n, "scalars": _host(scalars[col])}
        if self.tally:
            with self.tracer.tally():
                for sl in scalars:
                    self.work["msm"].append(roofline.msm_work(sl.shape[0], roofline.live_digits(sl)))
        with self.tracer.range("msm"):
            out = orig(points, scalars)
        if "msm" in self.faults:
            out = [None if p is None else (p[0], (Q - p[1]) % Q) for p in out]
        if sample:
            rec["point"] = out[col]
            self.samples["msm"].append(rec)
        return out

    # --- the proof and its opening -------------------------------------------

    def _recording(self) -> bool:
        return self._proof is not None

    def _prove(self, orig, srs, pk, *args, **kwargs):
        if "stale" in self.faults and self._last is not None and self.rng is not None:
            return self._last
        if not (self.proving and self.rng is not None):
            self._last = orig(srs, pk, *args, **kwargs)
            return self._last
        vk = pk.vk
        self._proof = {"n": vk.domain.n, "key_points": list(vk.fixed_commitments) + list(vk.sigma_commitments),
                       "written": [], "polys": {}, "commits": [], "h_chunks": None}
        try:
            proof = orig(srs, pk, *args, **kwargs)
        finally:
            rec, self._proof = self._proof, None
        self.proofs.append(rec)
        self._last = proof
        return proof

    def _write_point(self, orig, tr, pt):
        if self._recording():
            self._proof["written"].append(pt)
        return orig(tr, pt)

    def _evaluate(self, orig, f, poly, powers):
        out = orig(f, poly, powers)
        if "eval" in self.faults and self._recording() and not self._proof.get("faulted"):
            self._proof["faulted"] = True
            out = out.clone()
            out[..., 0] ^= 1
        return out

    def _build_quotient(self, orig, *args, **kwargs):
        chunks = orig(*args, **kwargs)
        if self._recording():
            with self.tracer.tally():
                self._proof["h_chunks"] = [_limbs(c) for c in chunks]
        return chunks

    def _open(self, orig, srs, queries, labels, v_ch, tr, kzg_commit, msc, enc):
        if not self._recording():
            return orig(srs, queries, labels, v_ch, tr, kzg_commit, msc, enc)
        rec = self._proof
        rec.update(labels=list(labels), v=v_ch)
        rec["queries"] = [(pt, int(val)) for _obj, pt, val in queries]

        def keep(lab):
            def copy(t):
                if lab not in rec["polys"]:
                    with self.tracer.tally():
                        rec["polys"][lab] = _limbs(t)
            return copy

        resident, wrapped = [], []
        for (obj, pt, val), lab in zip(queries, labels):
            if hasattr(obj, "get"):
                obj = _KeepLazy(obj, keep(lab))
            else:
                resident.append((lab, obj))
            wrapped.append((obj, pt, val))

        def commit(srs_, coeffs):
            point = kzg_commit(srs_, coeffs)
            with self.tracer.tally():
                rec["commits"].append((_limbs(coeffs), point))
            return point

        out = orig(srs, wrapped, labels, v_ch, _Transcript(tr, rec), commit, msc, enc)
        with self.tracer.tally():
            for lab, obj in resident:
                if lab not in rec["polys"]:
                    rec["polys"][lab] = _limbs(obj)
        return out

    def install(self) -> None:
        from scroll_prover_tpu_torch.ops import msm_tile, ntt_tile
        from scroll_prover_tpu_torch.ops import poly as poly_ops
        from scroll_prover_tpu_torch.proof_system import transcript
        from scroll_prover_tpu_torch.proof_system.plonk import multiopen, prover

        hooks = self
        orig = {"t": ntt_tile.TiledDomain._transform, "m": msm_tile.msm_v2_host_batch, "p": prover.prove,
                "q": prover._build_quotient, "o": multiopen.shplonk_open,
                "w": transcript._TranscriptBase.write_point, "e": poly_ops.eval_poly_with_powers}

        def transform(dom, x, inverse, scale):
            return hooks._transform(orig["t"], dom, x, inverse, scale)

        def msm(points, scalars):
            return hooks._msm(orig["m"], points, scalars)

        def prove(srs, pk, *args, **kwargs):
            return hooks._prove(orig["p"], srs, pk, *args, **kwargs)

        def build_quotient(*args, **kwargs):
            return hooks._build_quotient(orig["q"], *args, **kwargs)

        def shplonk_open(*args):
            return hooks._open(orig["o"], *args)

        def write_point(tr, pt):
            return hooks._write_point(orig["w"], tr, pt)

        def evaluate(f, poly, powers):
            return hooks._evaluate(orig["e"], f, poly, powers)

        self._saved = [(ntt_tile.TiledDomain, "_transform", orig["t"]), (msm_tile, "msm_v2_host_batch", orig["m"]),
                       (prover, "prove", orig["p"]), (prover, "_build_quotient", orig["q"]),
                       (multiopen, "shplonk_open", orig["o"]), (transcript._TranscriptBase, "write_point", orig["w"]),
                       (poly_ops, "eval_poly_with_powers", orig["e"])]
        ntt_tile.TiledDomain._transform = transform
        msm_tile.msm_v2_host_batch = msm
        prover.prove = prove
        prover._build_quotient = build_quotient
        multiopen.shplonk_open = shplonk_open
        transcript._TranscriptBase.write_point = write_point
        if self.faults:
            poly_ops.eval_poly_with_powers = evaluate

    def uninstall(self) -> None:
        for owner, name, orig in self._saved:
            setattr(owner, name, orig)
        self._saved = []

