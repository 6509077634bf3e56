"""Benchmark: seed-extension throughput on the GPU (DP cell updates/s).

The extension kernel (ops/extend.py, native/extend.cu) is the hot loop of
every aligner stage.  This measures it with the production traceback at
the production band W=256 and prints ONE JSON line:
    {"metric": "dp_cell_updates_per_s", "value": N, "unit": "cells/s",
     "vs_baseline": R}

It needs a GPU and exits with an error on any other platform.  Before
timing, a parity gate checks the compiled kernel against the
adaptive-band scan path on planted lanes.

vs_baseline: the reference publishes no numbers (BASELINE.md) and its
aligner binaries are absent submodules, so the baseline is a numpy
banded DP on this host, scaled by 8x to approximate the reference's
16-thread operating point: vs_baseline = GPU cells/s / (8 * numpy
cells/s).
"""

import json
import os
import sys
import time

import numpy as np


def make_inputs(rng, B, NQ, W):
    NT = NQ + 2 * W
    q = rng.integers(0, 4, (B, NQ)).astype(np.uint8)
    t = rng.integers(0, 4, (B, NT)).astype(np.uint8)
    # plant alignments with 10% noise so the adaptive band does real work
    noise = rng.random((B, NQ)) < 0.1
    planted = np.where(noise, rng.integers(0, 4, (B, NQ)).astype(np.uint8),
                       q)
    t[:, W:W + NQ] = planted
    qlen = np.full(B, NQ, np.int32)
    tlen = np.full(B, NT, np.int32)
    c0 = np.full(B, W, np.int32)
    return q, qlen, t, tlen, c0


def measure_kernel(B, NQ, W, iters=5):
    """Kernel rate including the production traceback (traceback_fast:
    packed-word device walk + two-transfer fetch + native run-length
    expansion), as the aligner's _dispatch_static/_finish_static run."""
    import jax
    from aligngraph2_tpu.ops.extend import (extend_cuda, traceback_fast,
                                            T_SENTINEL)

    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, NQ)).astype(np.uint8)
    noise = rng.random((B, NQ)) < 0.1
    planted = np.where(noise, rng.integers(0, 4, (B, NQ)).astype(np.uint8),
                       q)
    t = np.full((B, NQ + W), T_SENTINEL, np.uint8)
    t[:, W // 2:W // 2 + NQ] = planted
    qd = jax.device_put(q)
    td = jax.device_put(t)
    qlen = jax.device_put(np.full(B, NQ, np.int32))

    def run():
        r = extend_cuda(qd, td, qlen, W=W, match=2, mismatch=-4, gap=-3,
                        x_drop=250)
        # traceback_fast ends in host numpy outputs, which synchronizes
        traceback_fast(r.words, r.best_i, r.best_j, max_steps=2 * NQ + W)
        np.asarray(r.score)
        return r

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    dt = (time.perf_counter() - t0) / iters
    return B * NQ * W / dt


def _cpu_baseline(B=4, NQ=2048, W=256, iters=3):
    """Numpy banded DP (vectorized per row over the band) — a fair proxy
    for a well-written CPU implementation on this host, with no XLA
    compile cost.  Same recurrence as the kernels (local, linear gaps,
    Kogge-Stone left chain)."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, NQ)).astype(np.int8)
    t = rng.integers(0, 4, (B, NQ + W)).astype(np.int8)
    t[:, W // 2:W // 2 + NQ] = q
    NEG = -(1 << 28)

    def run():
        H = np.zeros((B, W), np.int32)
        best = np.zeros(B, np.int32)
        for i in range(1, NQ + 1):
            tw = t[:, i - 1:i - 1 + W].astype(np.int32)
            sub = np.where(tw == q[:, i - 1:i].astype(np.int32), 2, -4)
            up = np.concatenate(
                [H[:, 1:], np.full((B, 1), NEG, np.int32)], axis=1)
            M = np.maximum(np.maximum(H + sub, up - 3), 0)
            H = M
            sh = 1
            while sh < W:
                shifted = np.concatenate(
                    [np.full((B, sh), NEG, np.int32), H[:, :-sh]], axis=1)
                H = np.maximum(H, shifted - 3 * sh)
                sh <<= 1
            best = np.maximum(best, H.max(axis=1))
        return best

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    dt = (time.perf_counter() - t0) / iters
    return B * NQ * W / dt


def verify_kernel_on_hardware(B=128, NQ=1024, W=256, seed=7):
    """Hardware correctness gate: the compiled kernel (+ fast traceback)
    must equal the lax.scan path on random planted lanes, so a
    miscompile fails the run loudly instead of shipping silently."""
    import jax
    from aligngraph2_tpu.ops.banded_dp import banded_align, traceback
    from aligngraph2_tpu.ops.extend import (
        extend_cuda, traceback_fast, Q_SENTINEL, T_SENTINEL)

    rng = np.random.default_rng(seed)
    q = np.full((B, NQ), Q_SENTINEL, np.uint8)
    qlen = np.zeros(B, np.int32)
    t = np.full((B, NQ + W), T_SENTINEL, np.uint8)
    for b in range(B):
        n = int(rng.integers(NQ // 2, NQ + 1))
        base = rng.integers(0, 4, NQ + W).astype(np.uint8)
        t[b] = base
        piece = base[W // 2:W // 2 + n].copy()
        noise = rng.random(n) < 0.1
        piece[noise] = rng.integers(0, 4, n)[noise].astype(np.uint8)
        q[b, :n] = piece
        qlen[b] = n
    scan = banded_align(q, qlen, t.copy(), np.full(B, NQ + W, np.int32),
                        np.full(B, W // 2, np.int32), W=W)
    s_moves, s_n, s_si, s_sj = traceback(
        scan.dirs, scan.centers, scan.best_i, scan.best_j,
        max_steps=2 * NQ)
    for x_drop in (0, 250):
        res = extend_cuda(jax.device_put(q), jax.device_put(t),
                          jax.device_put(qlen), W=W, match=2, mismatch=-4,
                          gap=-3, x_drop=x_drop)
        moves, nmoves, si, sj = traceback_fast(
            res.words, res.best_i, res.best_j, max_steps=2 * NQ)
        for name, got, want in (("scores", res.score, scan.score),
                                ("best_i", res.best_i, scan.best_i),
                                ("move counts", nmoves, s_n),
                                ("start rows", si, s_si)):
            assert np.array_equal(np.asarray(got), np.asarray(want)), \
                f"kernel(x_drop={x_drop}) {name} != scan"
    print(f"kernel hardware parity: ok ({B} lanes, x_drop 0/250)",
          flush=True)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aligngraph2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    from aligngraph2_tpu.ops.extend import load_extension_kernel

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, found {dev.platform!r}")
    load_extension_kernel()
    verify_kernel_on_hardware()
    rate = measure_kernel(B=1024, NQ=8192, W=256, iters=5)
    cpu_rate = _cpu_baseline()
    vs = rate / (8 * cpu_rate) if cpu_rate else None
    print(json.dumps({
        "metric": "dp_cell_updates_per_s",
        "value": rate,
        "unit": "cells/s",
        "vs_baseline": vs,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
