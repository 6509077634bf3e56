"""Static-band extension (ops/extend.py): the plain reference, the
wrapper around it, and the traceback shared with the GPU kernel.

The CPU runs the reference; the CUDA kernel has no interpret mode, so
its tests carry the ``gpu`` marker and skip here (chip_smoke.py runs the
same comparisons on the card).  The contract: identical scores to the
adaptive-band scan path whenever the alignment stays within the static
band, and traceback that exactly reconstructs a scoring-consistent
alignment.
"""

import numpy as np
import pytest

from aligngraph2_tpu.io.seqdb import encode_seq, decode_seq
from aligngraph2_tpu.ops import extend as ext
from aligngraph2_tpu.ops.banded_dp import (DIAG, LEFT, STOP, UP,
                                           banded_align, moves_to_strings,
                                           traceback)
from aligngraph2_tpu.ops.extend import (Q_SENTINEL, T_SENTINEL,
                                        extend_reference,
                                        standard_frame_windows,
                                        traceback_t)
from tests.synth import random_genome, mutate

SCORES = dict(match=2, mismatch=-4, gap=-3)


def run_ref(qs, ts, diags, NQ, W=128, x_drop=0):
    B = len(qs)
    q = np.full((B, NQ), Q_SENTINEL, np.uint8)
    qlen = np.zeros(B, np.int32)
    for i, qq in enumerate(qs):
        q[i, :len(qq)] = qq
        qlen[i] = len(qq)
    t, starts = standard_frame_windows(list(ts), list(diags), NQ, W)
    res = extend_reference(q, t, qlen, W=W, x_drop=x_drop, **SCORES)
    return res, starts, q, t


def direct_static_band(q, t, qlen, W, match=2, mismatch=-4, gap=-3):
    """The recurrence cell by cell, with the left gap as the textbook
    H[j] = max(M[j], H[j-1] + gap): (score, best_i, best_j, codes
    (NQ, W)) of one lane, rows past qlen never computed."""
    NQ = len(q)
    H = np.zeros(W, np.int64)
    codes = np.zeros((NQ, W), np.uint8)
    best, bi, bj = 0, 0, 0
    for i in range(1, NQ + 1):
        Hn = np.zeros(W, np.int64)
        for j in range(W):
            dv = H[j] + (match if t[i - 1 + j] == q[i - 1] else mismatch)
            uv = (H[j + 1] if j + 1 < W else -(1 << 28)) + gap
            m = max(dv, uv)
            code = (DIAG if dv >= uv else UP) if m > 0 else STOP
            m = max(m, 0)
            h = max(m, Hn[j - 1] + gap) if j > 0 else m
            codes[i - 1, j] = LEFT if h > m else code
            Hn[j] = h
        H = Hn
        if H.max() > best:
            best, bi, bj = int(H.max()), i, int(np.argmax(H))
        if i >= qlen:
            break
    return best, bi, bj, codes


def test_perfect_match_score():
    g = encode_seq("ACGT" * 64)
    res, starts, _, _ = run_ref([g], [g], [0], NQ=256, W=128)
    assert int(res.score[0]) == 2 * 256


def test_matches_scan_path_scores(rng):
    NQ, W = 256, 128
    qs, ts, diags = [], [], []
    for _ in range(8):
        g = encode_seq(random_genome(rng, 800))
        start = int(rng.integers(0, 400))
        ln = int(rng.integers(150, 256))
        read = mutate(rng, decode_seq(g[start:start + ln]),
                      sub=0.05, ins=0.02, dele=0.02)
        qs.append(encode_seq(read))
        ts.append(g)
        diags.append(start)
    res, starts, q, t = run_ref(qs, ts, diags, NQ=NQ, W=W)
    for b in range(8):
        q1 = np.zeros((1, NQ), np.uint8)
        q1[0, :len(qs[b])] = qs[b]
        t1 = t[b:b + 1]
        scan = banded_align(
            q1, np.array([len(qs[b])], np.int32),
            t1, np.array([t1.shape[1]], np.int32),
            np.array([W // 2], np.int32), W=W)
        assert int(res.score[b]) == int(scan.score[0]), f"b={b}"


def test_pallas_traceback_reconstructs(rng):
    NQ, W = 256, 128
    g = encode_seq(random_genome(rng, 700))
    read = mutate(rng, decode_seq(g[100:340]), sub=0.04, ins=0.02,
                  dele=0.02)
    qc = encode_seq(read)
    res, starts, q, t = run_ref([qc], [g], [100], NQ=NQ, W=W)
    moves, n, si, sj = traceback_t(res.words, res.best_i, res.best_j,
                                   max_steps=2 * NQ + W)
    b = 0
    si_, sj_ = int(si[b]), int(sj[b])
    start_t = si_ + sj_  # standard frame: p = i + j
    qstr, tstr, qe, te = moves_to_strings(
        np.asarray(moves[b]), qc, si_, start_t, t[b])
    assert qstr.replace("-", "") == decode_seq(qc[si_:qe])
    assert tstr.replace("-", "") == decode_seq(t[b][start_t:te])
    score = sum(2 if a == c else (-3 if "-" in (a, c) else -4)
                for a, c in zip(qstr, tstr))
    assert score == int(res.score[0])
    assert qe - si_ > 0.9 * len(qc)


def test_sentinels_never_align():
    NQ, W = 128, 128
    q = np.full((8, NQ), Q_SENTINEL, np.uint8)
    t = np.full((8, NQ + W), T_SENTINEL, np.uint8)
    res = extend_reference(q, t, np.full(8, NQ, np.int32), W=W, x_drop=0,
                           **SCORES)
    assert int(np.asarray(res.score).max()) == 0


def test_batch_lanes_independent(rng):
    """Alignments in different lanes must not leak into each other."""
    NQ, W = 128, 128
    g1 = encode_seq(random_genome(rng, 300))
    g2 = encode_seq(random_genome(rng, 300))
    res2, _, _, _ = run_ref([g1[:100], g2[:120]], [g1, g2], [0, 0],
                            NQ=NQ, W=W)
    res1a, _, _, _ = run_ref([g1[:100]], [g1], [0], NQ=NQ, W=W)
    res1b, _, _, _ = run_ref([g2[:120]], [g2], [0], NQ=NQ, W=W)
    assert int(res2.score[0]) == int(res1a.score[0]) == 200
    assert int(res2.score[1]) == int(res1b.score[0]) == 240


def test_traceback_fast_matches_traceback_t(rng):
    """traceback_fast (packed-word device walk + host run-length
    expansion) must equal traceback_t move-for-move, including the
    truncation-at-max_steps semantics."""
    from aligngraph2_tpu.ops.extend import traceback_fast
    NQ, W = 256, 64
    B = 8
    qs, ts, diags = [], [], []
    for b in range(B):
        g = encode_seq(random_genome(rng, NQ + 50))
        read = encode_seq(mutate(rng, decode_seq(g[:NQ]), 0.12))[:NQ]
        qs.append(read)
        ts.append(g)
        diags.append(0)
    res, starts, q, t = run_ref(qs, ts, diags, NQ, W=W)
    for ms in (2 * NQ, 100, 32, 15):
        m1, n1, i1, j1 = traceback_t(res.words, res.best_i, res.best_j,
                                     max_steps=ms)
        m2, n2, i2, j2 = traceback_fast(res.words, res.best_i,
                                        res.best_j, max_steps=ms)
        assert np.array_equal(np.asarray(m1), m2), ms
        assert np.array_equal(np.asarray(n1), n2), ms
        # start coordinates: traceback_t's device cursor equals the
        # host-recomputed start exactly (truncated or not) because both
        # apply the same move deltas to the same emitted prefix
        assert np.array_equal(np.asarray(i1), i2), ms
        assert np.array_equal(np.asarray(j1), j2), ms


def test_native_expand_matches_numpy_spec(rng):
    """agx_expand (native run-length expansion) == expand_packed_moves
    on random run/terminator streams, incl. truncation mid-run and at a
    terminator."""
    from aligngraph2_tpu.ops.extend import expand_packed_moves
    from aligngraph2_tpu.ops.native import expand_moves_native
    B, C = 16, 40
    runs = rng.integers(0, 17, (B, C)).astype(np.uint8)
    mvs = rng.choice(np.array([0, 1, 2, 3], np.uint8), (B, C),
                     p=[0.2, 0.1, 0.35, 0.35])
    bi = rng.integers(0, 500, B).astype(np.int32)
    bj = rng.integers(0, 64, B).astype(np.int32)
    for ms in (1000, 64, 17, 3):
        ref = expand_packed_moves(runs, mvs, C, bi, bj, ms)
        got = expand_moves_native(runs, mvs, C, bi, bj, ms)
        assert got is not None, "native core unavailable"
        for a, b in zip(ref, got):
            assert np.array_equal(np.asarray(a), np.asarray(b)), ms


def test_xdrop_matches_full_kernel(rng):
    """With x_drop on, lanes whose frontier never falls x_drop below
    their best must give the x_drop=0 result: same best cell, same
    traceback (rows up to best_i are always written)."""
    NQ, W = 256, 128
    qs, ts, diags = [], [], []
    for _ in range(8):
        g = encode_seq(random_genome(rng, 800))
        start = int(rng.integers(0, 400))
        ln = int(rng.integers(120, 256))
        read = mutate(rng, decode_seq(g[start:start + ln]),
                      sub=0.05, ins=0.02, dele=0.02)
        qs.append(encode_seq(read))
        ts.append(g)
        diags.append(start)
    full, _, _, _ = run_ref(qs, ts, diags, NQ, W=W)
    xd, _, _, _ = run_ref(qs, ts, diags, NQ, W=W, x_drop=250)
    np.testing.assert_array_equal(np.asarray(xd.score),
                                  np.asarray(full.score))
    np.testing.assert_array_equal(np.asarray(xd.best_i),
                                  np.asarray(full.best_i))
    np.testing.assert_array_equal(np.asarray(xd.best_j),
                                  np.asarray(full.best_j))
    mf, nf, sif, sjf = traceback_t(full.words, full.best_i, full.best_j,
                                   max_steps=2 * NQ)
    mx, nx, six, sjx = traceback_t(xd.words, xd.best_i, xd.best_j,
                                   max_steps=2 * NQ)
    np.testing.assert_array_equal(np.asarray(mx), np.asarray(mf))
    np.testing.assert_array_equal(np.asarray(six), np.asarray(sif))


def test_xdrop_short_reads_stop_early(rng):
    """Short reads in a long bucket: lanes stop at qlen and still give
    the right scores and best rows."""
    NQ, W = 256, 128
    g = encode_seq(random_genome(rng, 600))
    reads, ts, diags = [], [], []
    for b in range(8):
        start = 100 + 10 * b
        reads.append(g[start:start + 64])   # a quarter of NQ
        ts.append(g)
        diags.append(start)
    xd, _, _, _ = run_ref(reads, ts, diags, NQ, W=W, x_drop=100)
    np.testing.assert_array_equal(np.asarray(xd.score), np.full(8, 128))
    np.testing.assert_array_equal(np.asarray(xd.best_i), np.full(8, 64))


def test_xdrop_stops_a_lane_that_falls_behind(rng):
    """A lane whose read leaves its window's diagonal stops once its
    frontier falls x_drop below its best: rows after that write STOP."""
    NQ, W = 256, 64
    g = encode_seq(random_genome(rng, 700))
    read = np.concatenate([g[200:264], encode_seq(random_genome(rng, 192))])
    res, _, _, _ = run_ref([read], [g], [200], NQ, W=W, x_drop=20)
    assert int(res.score[0]) >= 128
    codes = np.asarray(ext.unpack_words(res.words))[0]
    dead = np.flatnonzero(codes.any(axis=1))[-1] + 1
    assert 64 <= int(res.best_i[0]) <= dead < NQ // 2
    assert not codes[dead:].any()


@pytest.mark.parametrize("x_drop", [0, 40])
def test_reference_matches_direct_recurrence(rng, x_drop):
    """The cummax gap chain and the packed word layout equal the
    recurrence written cell by cell, on every row each lane computes."""
    NQ, W = 48, 32
    qs, ts, diags = [], [], []
    for b in range(4):
        g = encode_seq(random_genome(rng, 200))
        read = encode_seq(mutate(rng, decode_seq(g[40:40 + 30 + 4 * b]),
                                 sub=0.1, ins=0.05, dele=0.05))[:NQ]
        qs.append(read)
        ts.append(g)
        diags.append(40)
    res, _, q, t = run_ref(qs, ts, diags, NQ, W=W, x_drop=x_drop)
    assert res.words.shape == (4, NQ // 16, W)
    codes = np.asarray(ext.unpack_words(res.words))
    for b in range(4):
        best, bi, bj, want = direct_static_band(q[b], t[b], len(qs[b]), W)
        assert (int(res.score[b]), int(res.best_i[b]),
                int(res.best_j[b])) == (best, bi, bj)
        rows = int(res.best_i[b])
        np.testing.assert_array_equal(codes[b, :rows], want[:rows])


def test_reference_matches_scan_path_at_65536(rng):
    """The longest static bucket: the reference equals the adaptive-band
    scan path in score, best row, move count and start row on planted
    PacBio-like reads (bounded drift, 13% error)."""
    from chip_smoke import planted_lanes
    NQ, W = 65536, 256
    q, t, qlen = planted_lanes(rng, 2, NQ, distinct=2)
    res = extend_reference(q, t, qlen, W=W, x_drop=250, **SCORES)
    moves, n, si, sj = ext.traceback_fast(res.words, res.best_i, res.best_j,
                                          max_steps=2 * NQ + W)
    scan = banded_align(q, qlen, t, np.full(2, NQ + W, np.int32),
                        np.full(2, W // 2, np.int32), W=W)
    s_moves, s_n, s_si, s_sj = traceback(
        scan.dirs, scan.centers, scan.best_i, scan.best_j,
        max_steps=2 * NQ + W)
    np.testing.assert_array_equal(np.asarray(res.score),
                                  np.asarray(scan.score))
    np.testing.assert_array_equal(np.asarray(res.best_i),
                                  np.asarray(scan.best_i))
    np.testing.assert_array_equal(n, np.asarray(s_n))
    np.testing.assert_array_equal(si, np.asarray(s_si))
    assert (np.asarray(res.score) > qlen).all()


@pytest.mark.parametrize("platform,name", [("gpu", "kernel"),
                                           ("cpu", "reference")])
def test_extension_impl_by_platform(monkeypatch, platform, name):
    monkeypatch.setattr(ext, "load_extension_kernel", lambda: None)
    got, fn = ext.extension_impl(platform)
    assert got == name
    assert fn is (ext.extend_cuda if platform == "gpu"
                  else ext.extend_reference)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter"])
def test_extension_impl_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no seed extension"):
        ext.extension_impl(platform)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """On the GPU a build failure is an error with the compiler's words,
    never a quiet switch to another path."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc refuses' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(ext, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(ext, "_CU_SO", str(tmp_path / "libextend.so"))
    monkeypatch.setattr(ext, "_kernel_lib", None)
    with pytest.raises(RuntimeError, match="fake nvcc refuses"):
        ext.load_extension_kernel()


@pytest.mark.parametrize("n,cap,want", [(1, 4096, 32), (32, 4096, 32),
                                        (33, 4096, 64), (1000, 4096, 1024),
                                        (5000, 4096, 4096), (3, 16, 16),
                                        (1000, 1632, 1024)])
def test_padded_lanes(n, cap, want):
    assert ext.padded_lanes(n, cap) == want


class _FakeDevice:
    platform = "gpu"

    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


def test_max_lanes_from_device_memory():
    assert ext.max_lanes(8192, 256, _FakeDevice(
        {"bytes_limit": 60 << 30})) == ext.MAX_LANES
    n = ext.max_lanes(65536, 256, _FakeDevice({"bytes_limit": 60 << 30}))
    assert n % 32 == 0
    assert 2 * n * ext.lane_bytes(65536, 256) <= (60 << 30) // 4
    # a small card gives small batches: no floor overrides the budget
    assert ext.max_lanes(65536, 256, _FakeDevice(
        {"bytes_limit": 64 << 20})) == 1
    import jax
    assert ext.max_lanes(8192, 256, jax.devices()[0]) == ext.CPU_LANES


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 1 << 20}])
def test_max_lanes_refuses_unknown_or_tiny_memory(stats):
    with pytest.raises(RuntimeError):
        ext.max_lanes(65536, 256, _FakeDevice(stats))


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu, rng):
    """The compiled kernel against the reference on planted lanes."""
    from chip_smoke import planted_lanes
    NQ, W = 2048, 256
    q, t, qlen = planted_lanes(rng, 64, NQ, distinct=16)
    ext.load_extension_kernel()
    for x_drop in (0, 250):
        got = ext.extend_cuda(q, t, qlen, W=W, x_drop=x_drop, **SCORES)
        want = extend_reference(q, t, qlen, W=W, x_drop=x_drop, **SCORES)
        for f in ("score", "best_i", "best_j"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
