"""Reduced-graph consensus (the device-path specification) vs the
sequential AlnGraph oracle — must be bit-identical on every window.

The reduced path's claim: identical insert chains between the same
anchors always fully merge under AlnGraphBoost::mergeNodes with counts
summing and first-created indices surviving, so the pre-merged
(aggregated) graph plus the same order-keyed merge reproduces the
sequential result exactly — including edge-list orderings that the
best-path strict-'>' tie break observes.  This fuzz hammers that claim
with heavy duplication, equal scores/weights (tie-prone), interleaved
deletes inside insert runs (bbpos divergence), and boundary cases.
"""

import numpy as np
import pytest

from aligngraph2_tpu.consensus.poa import AlnGraph, normalize_gaps
from aligngraph2_tpu.consensus.reduced import reduced_window_consensus

BASES = "ACGT"


def _oracle(skeleton, alns, min_weight=0):
    g = AlnGraph(skeleton)
    for start, qs, ts, w in alns:
        g.add_aln(start, qs, ts, w)
    g.merge_nodes()
    return g.consensus(min_weight)


def _rand_read_aln(rng, skeleton, err, dup_pool=None):
    """A gap-normalized alignment against a random skeleton slice.

    With a dup_pool, sometimes replays a previous alignment exactly
    (forcing identical chains) or with a shifted start."""
    L = len(skeleton)
    if dup_pool and len(dup_pool) > 3 and rng.random() < 0.35:
        start, qs, ts, _ = dup_pool[rng.integers(0, len(dup_pool))]
        return (start, qs, ts, int(rng.integers(1, 4)))
    ln = int(rng.integers(3, max(4, L)))
    start = int(rng.integers(1, L - ln + 2))
    t = skeleton[start - 1:start - 1 + ln]
    qs, ts = [], []
    for ch in t:
        r = rng.random()
        if r < err * 0.3:
            qs.append(BASES[rng.integers(0, 4)])
            ts.append(ch)
        elif r < err * 0.55:
            qs.append("-")
            ts.append(ch)
        elif r < err:
            for _ in range(int(rng.integers(1, 4))):
                qs.append(BASES[rng.integers(0, 4)])
                ts.append("-")
            qs.append(ch)
            ts.append(ch)
        else:
            qs.append(ch)
            ts.append(ch)
    qn, tn = normalize_gaps("".join(qs), "".join(ts))
    return (start, qn, tn, int(rng.integers(1, 4)))


@pytest.mark.parametrize("seed", range(8))
def test_reduced_equals_oracle_fuzz(seed):
    rng = np.random.default_rng(seed)
    for case in range(6):
        L = int(rng.integers(4, 40))
        skeleton = "".join(BASES[i] for i in rng.integers(0, 4, L))
        n_aln = int(rng.integers(1, 25))
        err = float(rng.choice([0.1, 0.3, 0.6]))
        alns = []
        for _ in range(n_aln):
            alns.append(_rand_read_aln(rng, skeleton, err, alns))
        for min_weight in (0, 2):
            exp = _oracle(skeleton, alns, min_weight)
            got = reduced_window_consensus(skeleton, alns, min_weight)
            assert got == exp, (seed, case, min_weight, skeleton, alns)


def test_reduced_uniform_weights_tie_break():
    """All-equal weights maximize score ties in the backward DP; the
    reduced path must pick the same first-encountered max."""
    rng = np.random.default_rng(77)
    skeleton = "ACGTACGTACGTACGT"
    alns = []
    for _ in range(20):
        a = _rand_read_aln(rng, skeleton, 0.5, alns)
        alns.append((a[0], a[1], a[2], 1))
    assert reduced_window_consensus(skeleton, alns) == \
        _oracle(skeleton, alns)


def test_reduced_edge_cases():
    skeleton = "ACGT"
    # empty alignment list
    assert reduced_window_consensus(skeleton, []) == _oracle(skeleton, [])
    # deletion-only alignment (ENTER->EXIT edge)
    alns = [(1, "----", "ACGT", 2)]
    assert reduced_window_consensus(skeleton, alns) == \
        _oracle(skeleton, alns)
    # leading + trailing insert chains (ENTER / EXIT anchors)
    alns = [(1, "TTACGTGG", "--ACGT--", 3),
            (1, "TTACGTGG", "--ACGT--", 2),
            (1, "CCACGT", "--ACGT", 1)]
    assert reduced_window_consensus(skeleton, alns) == \
        _oracle(skeleton, alns)
    # zero/negative weight alignments are skipped
    alns = [(1, "ACGT", "ACGT", 0), (2, "CGT", "CGT", 5)]
    assert reduced_window_consensus(skeleton, alns) == \
        _oracle(skeleton, alns)
