#!/usr/bin/env python3
"""Smoke run of the reassembly pipeline on NVIDIA GPUs.

    python chip_smoke.py          # one card: the first visible one
    python chip_smoke.py --four   # only the four-card mesh path

One card, in order (any failure exits non-zero and prints no ok line):

  1. device    the devices are GPUs; card name and power limit as
               nvidia-smi reports them, the JAX version, host cores;
  2. build     build (or load) the extension kernel, native/extend.cu;
  3. kernel    the kernel against the plain reference (ops/extend.py)
               on planted PacBio-like lanes at W=256, NQ 2048..65536,
               x_drop 0 and 250: score, best cell, traceback moves and
               start must be equal; score, best_i, move count and start
               row must also equal ops/banded_dp.py.  Prints the time of
               the kernel, of the reference as XLA compiles it, and of
               banded_dp per bucket;
  4. device paths  device graph merge and consensus aggregation against
               their native cores, past one 1M-entry bucket;
  5. pipeline  aligngraph2_tpu.cli on the 5 Mb / 20x dataset of
               bench_e2e.py; all five outputs, and final.fasta against
               the synthetic truth: identity >= 0.95, coverage >= 0.99.

``--four`` runs the same pipeline on a (data, block) = 2x2 mesh of four
cards, after checking that a 4-device mesh aligns 2,000 reads of the
dataset exactly as a 1-device mesh does.

The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
W = 256
BUCKETS = (2048, 8192, 16384, 65536)
X_DROPS = (0, 250)
DISTINCT_LANES = 32          # generated lanes per bucket, tiled to a batch
MIN_IDENTITY = 0.95
MIN_COVERAGE = 0.99
OUTPUTS = ("final.fasta", "remainder.fasta", "exclude.fasta", "add.fasta",
           "connect_info.txt")


def noisy_copy(rng, src, p_sub=0.03, p_indel=0.10):
    """PacBio-like copy of ``src``: 13% error, indel-heavy.  Insertions
    and deletions come in groups of four of each, in random order, so the
    copy never drifts more than four bases off its diagonal."""
    import numpy as np
    n = len(src)
    indel = rng.random(n) < p_indel
    k = int(indel.sum())
    kinds = np.argsort(rng.random(((k + 7) // 8, 8)), axis=1) < 4
    is_ins = np.zeros(n, bool)
    is_ins[indel] = kinds.ravel()[:k]
    is_del = indel & ~is_ins
    width = np.where(is_del, 0, np.where(is_ins, 2, 1))
    start = np.cumsum(width) - width
    out = np.repeat(src, width)
    out[start[is_ins]] = rng.integers(0, 4, int(is_ins.sum()))
    sub = ~indel & (rng.random(n) < p_sub / (1 - p_indel))
    out[start[sub]] = (src[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return out.astype(np.uint8)


def planted_lanes(rng, B, NQ, distinct=DISTINCT_LANES):
    """(q, t, qlen) of B lanes, tiling ``distinct`` generated ones: reads
    of NQ*7/8..NQ bases copied from their window at the seed diagonal."""
    import numpy as np
    from aligngraph2_tpu.ops.extend import Q_SENTINEL
    q = np.full((distinct, NQ), Q_SENTINEL, np.uint8)
    t = rng.integers(0, 4, (distinct, NQ + W)).astype(np.uint8)
    qlen = np.zeros(distinct, np.int32)
    for b in range(distinct):
        n = NQ - int(rng.integers(0, NQ // 8))
        read = noisy_copy(rng, t[b, W // 2:W // 2 + n])[:NQ]
        q[b, :len(read)] = read
        qlen[b] = len(read)
    reps = -(-B // distinct)
    return (np.tile(q, (reps, 1))[:B], np.tile(t, (reps, 1))[:B],
            np.tile(qlen, reps)[:B])


def _timed(fn, reps=3):
    """Median wall seconds of fn() after one warm-up call; fn blocks."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase_device(four: bool) -> dict:
    import jax
    devs = jax.devices()
    bad = [d for d in devs if d.platform != "gpu"]
    if bad:
        raise RuntimeError(f"not a GPU: {bad[0]} (platform "
                           f"{bad[0].platform!r})")
    if four and len(devs) != 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devs)}")
    if not four and len(devs) != 1:
        raise RuntimeError(f"expected one visible GPU, found {len(devs)}")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis:
        smi.append("--id=" + vis)
    res = subprocess.run(smi, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    for line in res.stdout.strip().splitlines():
        print(line.strip())
    print(f"jax {jax.__version__}; {os.cpu_count()} host cores; "
          f"{len(devs)} x {devs[0].device_kind}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_build() -> None:
    from aligngraph2_tpu.ops.extend import load_extension_kernel
    t0 = time.perf_counter()
    load_extension_kernel()
    print(f"build: extension kernel ready in "
          f"{time.perf_counter() - t0:.1f} s")


def _check_bucket(rng, NQ: int) -> None:
    import jax
    import numpy as np
    from aligngraph2_tpu.ops.banded_dp import banded_align, traceback
    from aligngraph2_tpu.ops.extend import (extend_cuda, extend_reference,
                                            max_lanes, traceback_fast)
    B = max_lanes(NQ, W)
    q, t, qlen = planted_lanes(rng, B, NQ)
    qd, td, ld = (jax.device_put(a) for a in (q, t, qlen))
    cells = int(qlen.astype(np.int64).sum()) * W
    ms = 2 * NQ + W
    kw = dict(W=W, match=2, mismatch=-4, gap=-3)
    D = DISTINCT_LANES
    scan = banded_align(q[:D], qlen[:D], t[:D], np.full(D, NQ + W, np.int32),
                        np.full(D, W // 2, np.int32), W=W)
    s_moves, s_n, s_si, s_sj = traceback(
        scan.dirs, scan.centers, scan.best_i, scan.best_j, max_steps=ms)
    for x_drop in X_DROPS:
        got = extend_cuda(qd, td, ld, x_drop=x_drop, **kw)
        want = extend_reference(qd, td, ld, x_drop=x_drop, **kw)
        for f in ("score", "best_i", "best_j"):
            g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            if not np.array_equal(g, w):
                bad = int(np.flatnonzero(g != w)[0])
                raise AssertionError(
                    f"NQ={NQ} x_drop={x_drop}: kernel {f} != reference "
                    f"(lane {bad}: {g[bad]} vs {w[bad]})")
        tg = traceback_fast(got.words, got.best_i, got.best_j, max_steps=ms)
        tw = traceback_fast(want.words, want.best_i, want.best_j,
                            max_steps=ms)
        for name, g, w in zip(("moves", "n_moves", "start_i", "start_j"),
                              tg, tw):
            if not np.array_equal(g, w):
                raise AssertionError(f"NQ={NQ} x_drop={x_drop}: kernel "
                                     f"traceback {name} != reference")
        for name, g, w in (("score", got.score, scan.score),
                           ("best_i", got.best_i, scan.best_i),
                           ("n_moves", tg[1], s_n),
                           ("start_i", tg[2], s_si)):
            g, w = np.asarray(g)[:D], np.asarray(w)
            if not np.array_equal(g, w):
                raise AssertionError(f"NQ={NQ} x_drop={x_drop}: kernel "
                                     f"{name} != banded_dp")
    # times at the production setting, x_drop=250, each implementation
    # at the batch the aligner would give it
    xd = dict(kw, x_drop=250)
    t_kernel = _timed(lambda: extend_cuda(qd, td, ld, **xd)
                      .score.block_until_ready())
    t_ref = _timed(lambda: extend_reference(qd, td, ld, **xd)
                   .score.block_until_ready())
    Bs = max(1, min(64, (64 << 20) // (NQ * W)))
    sq, st, sl = (jax.device_put(a[:Bs]) for a in (q, t, qlen))
    sT = jax.device_put(np.full(Bs, NQ + W, np.int32))
    sc = jax.device_put(np.full(Bs, W // 2, np.int32))
    t_scan = _timed(lambda: banded_align(sq, sl, st, sT, sc, W=W, x_drop=250)
                    .score.block_until_ready())
    scan_cells = int(qlen[:Bs].astype(np.int64).sum()) * W
    print(f"kernel NQ={NQ} W={W}: equal to reference ({B} lanes) and "
          f"banded_dp ({D} lanes) at x_drop 0/250; "
          f"kernel {t_kernel * 1e3:.2f} ms ({cells / t_kernel:.4g} cells/s), "
          f"plain XLA {t_ref * 1e3:.2f} ms ({cells / t_ref:.4g} cells/s), "
          f"banded_dp {Bs} lanes {t_scan * 1e3:.2f} ms "
          f"({scan_cells / t_scan:.4g} cells/s)", flush=True)


def phase_kernel() -> None:
    import numpy as np
    rng = np.random.default_rng(7)
    for NQ in BUCKETS:
        _check_bucket(rng, NQ)


def phase_device_paths() -> None:
    from __graft_entry__ import _dryrun_device_merge_and_consensus
    t0 = time.perf_counter()
    _dryrun_device_merge_and_consensus(n_merge=1_500_000,
                                       backbone_len=400_000, n_alns=4000)
    print(f"device paths: merge positions/edges (1.5M entries) and "
          f"consensus (4000 alignments) equal the native cores "
          f"({time.perf_counter() - t0:.1f} s)")


def _dataset(work: str) -> dict:
    from bench_e2e import make_inputs
    t0 = time.perf_counter()
    paths = make_inputs(5.0, 20, 42, os.path.join(work, "data"))
    print(f"dataset: 5 Mb / 20x legacy, seed 42, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def phase_pipeline(work: str, paths: dict) -> None:
    from aligngraph2_tpu import cli
    from aligngraph2_tpu.io.fasta import read_seqs
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    from aligngraph2_tpu.ops import extend
    from bench_quality import _truth_metrics
    out = os.path.join(work, "out")
    before = dict(extend.BATCHES)
    t0 = time.perf_counter()
    rc = cli.main(["-r", paths["reads"], "-c", paths["ctg"],
                   "-g", paths["genome"], "-o", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli returned {rc}")
    runs = {k: extend.BATCHES[k] - before[k] for k in before}
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    missing = [o for o in OUTPUTS if not os.path.exists(os.path.join(out, o))]
    if missing:
        raise RuntimeError(f"missing outputs: {missing}")
    print(f"pipeline: {wall:.1f} s, {m['n_reads']} reads, "
          f"n_read_to_ctg {m['n_read_to_ctg']}, "
          f"n_read_to_ref {m['n_read_to_ref']}, "
          f"extension batches {runs}, mesh {m.get('mesh')}")
    print("stage walls (s): " + json.dumps(m["stage_s"]), flush=True)
    chains = list(read_seqs(os.path.join(out, "final.fasta")))
    truth = SeqDatabase.from_file(paths["truth"])
    q = _truth_metrics(chains, truth)
    print(f"quality: identity {q['identity']}, genome covered "
          f"{q['genome_covered']}, NGA50 {q['nga50']}, "
          f"{q['n_chains']} chains")
    if not (q["identity"] or 0) >= MIN_IDENTITY:
        raise AssertionError(f"identity {q['identity']} < {MIN_IDENTITY}")
    if not q["genome_covered"] >= MIN_COVERAGE:
        raise AssertionError(f"coverage {q['genome_covered']} < "
                             f"{MIN_COVERAGE}")


def phase_mesh_equality(paths: dict, n_reads: int = 2000) -> None:
    from aligngraph2_tpu.align.aligner import LongReadAligner
    from aligngraph2_tpu.config import AlignerConfig
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    from aligngraph2_tpu.parallel.mesh import make_mesh
    reads = SeqDatabase.from_file(paths["reads"])
    refs = SeqDatabase.from_file(paths["genome"])
    ids = list(range(min(n_reads, len(reads))))
    cfg = AlignerConfig()

    def run(mesh):
        alns = LongReadAligner(refs, cfg, mesh=mesh).align_reads(reads, ids)
        return [(a.query_name, a.ref_name, a.forward, a.score, a.qb, a.qe,
                 a.rb, a.re, a.qstr, a.tstr) for a in alns]

    t0 = time.perf_counter()
    got = run(make_mesh(4, block_parallel=2))
    t1 = time.perf_counter()
    want = run(make_mesh(1, block_parallel=1))
    t2 = time.perf_counter()
    if got != want:
        raise AssertionError("4-device mesh alignments differ from the "
                             "1-device mesh")
    print(f"mesh: {len(ids)} reads, {len(got)} alignments equal on 2x2 "
          f"and 1x1 meshes ({t1 - t0:.1f} s vs {t2 - t1:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "aligngraph2_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not args.four:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = vis.split(",")[0] if vis \
            else "0"
    sys.path.insert(0, HERE)
    from aligngraph2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    device = None
    current = "device"
    try:
        device = phase_device(args.four)
        current = "build"
        phase_build()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            if args.four:
                current = "dataset"
                paths = _dataset(work)
                current = "mesh"
                phase_mesh_equality(paths)
            else:
                current = "kernel"
                phase_kernel()
                current = "device paths"
                phase_device_paths()
                current = "dataset"
                paths = _dataset(work)
            current = "pipeline"
            phase_pipeline(work, paths)
    except Exception:
        traceback.print_exc()
        print(f"phase {current}: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
