import numpy as np
import pytest

from aligngraph2_tpu.io.seqdb import encode_seq, decode_seq
from aligngraph2_tpu.ops.banded_dp import (
    banded_align, traceback, numpy_local_align, moves_to_strings,
    DIAG, UP, LEFT)
from tests.synth import random_genome, mutate


def run_pair(q, t, W=64, match=2, mismatch=-4, gap=-3, c0=None):
    NQ = len(q)
    NT = len(t)
    qa = np.zeros((1, NQ), np.uint8)
    qa[0] = q
    ta = np.zeros((1, NT), np.uint8)
    ta[0] = t
    c0v = np.array([NT // 2 - NQ // 2 if c0 is None else c0], np.int32)
    res = banded_align(qa, np.array([NQ], np.int32), ta,
                       np.array([NT], np.int32), c0v, W=W, match=match,
                       mismatch=mismatch, gap=gap)
    return res


def test_exact_match_score():
    q = encode_seq("ACGTACGTGG")
    res = run_pair(q, q, c0=0)
    assert int(res.score[0]) == 2 * len(q)
    assert int(res.best_i[0]) == len(q)


def test_substring_match():
    t = encode_seq("TTTTTACGTACGTGGTTTTT")
    q = encode_seq("ACGTACGT")
    res = run_pair(q, t, c0=5)
    assert int(res.score[0]) == 16


def test_score_matches_numpy_oracle(rng):
    # wide band covers the whole matrix -> must equal unbanded SW
    for trial in range(5):
        n = int(rng.integers(20, 60))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = rng.integers(0, 4, int(rng.integers(20, 60))).astype(np.uint8)
        want, _, _ = numpy_local_align(q, t)
        res = run_pair(q, t, W=256, c0=len(t) // 2 - len(q) // 2)
        assert int(res.score[0]) == want, f"trial {trial}"


def test_mutated_read_aligns(rng):
    g = random_genome(rng, 2000)
    read = mutate(rng, g[500:1500], sub=0.05, ins=0.02, dele=0.02)
    q = encode_seq(read)
    t = encode_seq(g)
    res = run_pair(q, t, W=128, c0=500)
    # expect most bases to align: score > 1.2 per base is solid
    assert int(res.score[0]) > 1.2 * len(read)


def full_align(q, t, c0, W=128):
    res = banded_align(q[None].astype(np.uint8),
                       np.array([len(q)], np.int32),
                       t[None].astype(np.uint8),
                       np.array([len(t)], np.int32),
                       np.array([c0], np.int32), W=W)
    moves, n, si, sj = traceback(res.dirs, res.centers, res.best_i,
                                 res.best_j, max_steps=len(q) + len(t))
    si = int(si[0])
    sj = int(sj[0])
    centers = np.asarray(res.centers[0])
    start_t = si + centers[si] - W // 2 + sj
    qstr, tstr, qe, te = moves_to_strings(np.asarray(moves[0]), q, si,
                                          int(start_t), t)
    return res, qstr, tstr, si, int(start_t), qe, te


def test_traceback_reconstructs_alignment(rng):
    g = encode_seq(random_genome(rng, 1200))
    q = encode_seq(mutate(rng, decode_seq(g[200:1000]), sub=0.04, ins=0.02,
                          dele=0.02))
    res, qstr, tstr, qb, tb, qe, te = full_align(q, g, c0=200)
    assert len(qstr) == len(tstr)
    # gapped strings must spell the claimed intervals
    assert qstr.replace("-", "") == decode_seq(q[qb:qe])
    assert tstr.replace("-", "") == decode_seq(g[tb:te])
    # recomputing the score from the strings must match the DP score
    score = 0
    for a, b in zip(qstr, tstr):
        if a == "-" or b == "-":
            score += -3
        elif a == b:
            score += 2
        else:
            score += -4
    assert score == int(res.score[0])
    # alignment should cover most of the read
    assert qe - qb > 0.95 * len(q)


def test_batch_independence(rng):
    # results in a batch equal results computed singly
    n = 40
    qs = rng.integers(0, 4, (3, n)).astype(np.uint8)
    ts = rng.integers(0, 4, (3, 80)).astype(np.uint8)
    ts[1, 10:50] = qs[1]  # plant a perfect match
    c0 = np.array([20, 20, 20], np.int32)
    res = banded_align(qs, np.full(3, n, np.int32), ts,
                       np.full(3, 80, np.int32), c0, W=128)
    for b in range(3):
        single = banded_align(qs[b:b + 1], np.array([n], np.int32),
                              ts[b:b + 1], np.array([80], np.int32),
                              c0[b:b + 1], W=128)
        assert int(res.score[b]) == int(single.score[0])
    assert int(res.score[1]) == 2 * n


def test_band_drift_follows_accumulated_indels(rng):
    # 4% indels over 3000 bases accumulate diagonal drift well beyond a
    # static 64-wide band; the adaptive center must follow it
    g = random_genome(rng, 4000)
    read = mutate(rng, g[200:3200], sub=0.01, ins=0.04, dele=0.0)
    # pure insertions: diagonal drifts by ~ -120 over the read
    q = encode_seq(read)
    t = encode_seq(g)
    drift = len(read) - 3000
    assert abs(drift) > 64  # the premise: net drift exceeds the band
    res = run_pair(q, t, W=64, c0=200)
    assert int(res.score[0]) > 1.2 * 3000


def test_large_deletion_within_default_band(rng):
    # an 80-base deletion fits inside the default W=256 band: the left-gap
    # Kogge-Stone chain can bridge it in one row
    g = random_genome(rng, 3000)
    read = g[200:1200] + g[1280:2280]
    q = encode_seq(read)
    t = encode_seq(g)
    res = run_pair(q, t, W=256, c0=200)
    assert int(res.score[0]) > 1.8 * 1800


def test_xdrop_matches_full_for_surviving_lanes(rng):
    """Planted alignments never drop x_drop below their best, so the
    x-drop path must return exactly the full-path results."""
    W = 64
    NQ = 256
    B = 8
    genome = encode_seq(random_genome(rng, 4096))
    q = np.zeros((B, NQ), np.uint8)
    t = np.zeros((B, NQ + 2 * W), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.full(B, NQ + 2 * W, np.int32)
    c0 = np.full(B, W, np.int32)
    for b in range(B):
        n = int(rng.integers(NQ // 2, NQ + 1))
        s = int(rng.integers(W, len(genome) - NQ - 2 * W))
        piece = genome[s:s + n].copy()
        noise = rng.random(n) < 0.08
        piece[noise] = rng.integers(0, 4, n)[noise].astype(np.uint8)
        q[b, :n] = piece
        qlen[b] = n
        t[b] = genome[s - W:s + NQ + W]
    full = banded_align(q, qlen, t, tlen, c0, W=W)
    xd = banded_align(q, qlen, t, tlen, c0, W=W, x_drop=250)
    np.testing.assert_array_equal(np.asarray(xd.score),
                                  np.asarray(full.score))
    np.testing.assert_array_equal(np.asarray(xd.best_i),
                                  np.asarray(full.best_i))
    np.testing.assert_array_equal(np.asarray(xd.best_j),
                                  np.asarray(full.best_j))
    # traceback over the x-drop dirs reconstructs the same alignments
    mf, nf, sif, sjf = traceback(full.dirs, full.centers, full.best_i,
                                 full.best_j, max_steps=NQ + NQ + 2 * W)
    mx, nx, six, sjx = traceback(xd.dirs, xd.centers, xd.best_i,
                                 xd.best_j, max_steps=NQ + NQ + 2 * W)
    np.testing.assert_array_equal(np.asarray(nx), np.asarray(nf))
    np.testing.assert_array_equal(np.asarray(six), np.asarray(sif))


def test_xdrop_kills_noise_lane_early_and_keeps_prefix_best(rng):
    """A lane whose alignment ends mid-read must report the score it had
    at its peak, identical to the full path (x-drop only skips the
    hopeless tail)."""
    W = 64
    NQ = 512
    genome = encode_seq(random_genome(rng, 2048))
    # query: first 150 bases match the target, rest is unrelated noise
    q = np.zeros((1, NQ), np.uint8)
    s = 300
    q[0, :150] = genome[s:s + 150]
    q[0, 150:] = rng.integers(0, 4, NQ - 150).astype(np.uint8)
    t = genome[s - W:s - W + NQ + 2 * W][None, :].copy()
    qlen = np.array([NQ], np.int32)
    tlen = np.array([NQ + 2 * W], np.int32)
    c0 = np.array([W], np.int32)
    full = banded_align(q, qlen, t, tlen, c0, W=W)
    xd = banded_align(q, qlen, t, tlen, c0, W=W, x_drop=100)
    assert int(xd.score[0]) == int(full.score[0]) == 300
    assert int(xd.best_i[0]) == int(full.best_i[0]) == 150


class _FakeGpu:
    platform = "gpu"

    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


def test_scan_lanes_by_device():
    """CPU batches keep the 64 MB direction budget; a GPU's come from
    the memory it reports, capped, and no floor overrides the budget."""
    import jax
    from aligngraph2_tpu.ops.banded_dp import SCAN_MAX_LANES, scan_lanes
    cpu = jax.devices()[0]
    assert scan_lanes(8192, 8704, 256, cpu) == 32
    assert scan_lanes(131072, 131584, 256, cpu) == 2
    big = _FakeGpu({"bytes_limit": 60 << 30})
    assert scan_lanes(8192, 8704, 256, big) == SCAN_MAX_LANES
    small = _FakeGpu({"bytes_limit": 1 << 30})
    n = scan_lanes(65536, 66048, 256, small)
    assert 1 <= n < SCAN_MAX_LANES
    assert n * 65536 * 256 <= (1 << 30) // 16
    for stats in (None, {}, {"bytes_limit": 1 << 20}):
        with pytest.raises(RuntimeError):
            scan_lanes(65536, 66048, 256, _FakeGpu(stats))
