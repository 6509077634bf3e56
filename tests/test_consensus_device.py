"""Device (XLA) consensus aggregation vs the numpy/python spec.

Two layers of parity:
  1. encode_windows_np + aggregate_device + assemble_window_tables must
     reproduce extract_window_tables' WindowTables exactly (backbone
     sums, edge dict incl. first-touch times, chain groups).
  2. the full device pipeline's consensus strings must equal the
     sequential AlnGraph oracle.
Runs on the CPU backend per conftest; the same jits run on the GPU in
production.
"""

import numpy as np
import pytest

from aligngraph2_tpu.consensus.device import (aggregate_device,
                                              assemble_window_tables,
                                              encode_windows_np,
                                              window_consensus_via_device)
from aligngraph2_tpu.consensus.reduced import extract_window_tables
from tests.test_consensus_reduced import _oracle, _rand_read_aln

BASES = "ACGT"


def _tables_equal(a, b):
    assert a.skeleton_len == b.skeleton_len
    np.testing.assert_array_equal(a.bb_weight, b.bb_weight)
    np.testing.assert_array_equal(a.bb_cov, b.bb_cov)
    assert dict(a.edges) == dict(b.edges), (
        {k: v for k, v in a.edges.items() if b.edges.get(k) != v},
        {k: v for k, v in b.edges.items() if a.edges.get(k) != v})
    ka, kb = set(a.chains), set(b.chains)
    assert ka == kb, (ka - kb, kb - ka)
    for k in ka:
        assert list(a.chains[k]) == list(b.chains[k]), (k, a.chains[k],
                                                        b.chains[k])


@pytest.mark.parametrize("seed", range(6))
def test_device_tables_equal_spec(seed):
    rng = np.random.default_rng(seed)
    skeletons, window_alns = [], []
    for _ in range(int(rng.integers(1, 4))):
        L = int(rng.integers(4, 50))
        sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
        alns = []
        for _ in range(int(rng.integers(0, 20))):
            alns.append(_rand_read_aln(
                rng, sk, float(rng.choice([0.1, 0.4, 0.7])), alns))
        skeletons.append(sk)
        window_alns.append(alns)
    lens = [len(s) for s in skeletons]
    enc = encode_windows_np(window_alns, lens)
    agg = aggregate_device(enc)
    tables = assemble_window_tables(enc, agg, lens)
    for t_dev, (alns, L) in zip(tables, zip(window_alns, lens)):
        t_spec = extract_window_tables(L, alns)
        _tables_equal(t_dev, t_spec)


@pytest.mark.parametrize("seed", range(4))
def test_device_consensus_equals_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    skeletons, window_alns = [], []
    for _ in range(2):
        L = int(rng.integers(10, 60))
        sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
        alns = []
        for _ in range(int(rng.integers(3, 30))):
            alns.append(_rand_read_aln(
                rng, sk, float(rng.choice([0.1, 0.5])), alns))
        skeletons.append(sk)
        window_alns.append(alns)
    for mw in (0, 2):
        got = window_consensus_via_device(skeletons, window_alns, mw)
        exp = [_oracle(sk, alns, mw)
               for sk, alns in zip(skeletons, window_alns)]
        assert got == exp


def test_device_long_gap_and_overflow_chains():
    """Exercise the long-gap host patch (>= GAP_SLOTS consecutive
    deletions between matches) and the overflow chain path (> MAX_PACK
    inserted bases)."""
    rng = np.random.default_rng(5)
    L = 120
    sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
    # match 1 base, delete 40, match the rest
    q1 = sk[0] + "-" * 40 + sk[41:80]
    t1 = sk[:80]
    # 70-base insert run between two matches (overflow chain), twice
    # (identical -> still must merge exactly via the ops read-back)
    ins = "".join(BASES[i] for i in rng.integers(0, 4, 70))
    q2 = sk[10] + ins + sk[11]
    t2 = sk[10] + "-" * 70 + sk[11]
    alns = [(1, q1, t1, 3), (11, q2, t2, 2), (11, q2, t2, 1)]
    lens = [L]
    enc = encode_windows_np([alns], lens)
    agg = aggregate_device(enc)
    assert len(agg["long_cols"]) >= 1
    tables = assemble_window_tables(enc, agg, lens)
    _tables_equal(tables[0], extract_window_tables(L, alns))
    got = window_consensus_via_device([sk], [alns])
    assert got == [_oracle(sk, alns)]


def test_device_int32_wrap_chain():
    """A 16-base insert chain whose base at index 15 is G/T sets bit 31
    of the packed word; the numpy encoder must wrap to negative int32
    exactly like the native encoder (poacns.cpp) instead of raising
    OverflowError (numpy>=2) — ADVICE r3 medium."""
    sk = "ACGTACGTACGTACGTACGT"
    ins = "ACGTACGTACGTACGT"          # 16 bases, index 15 == 'T'
    assert len(ins) == 16 and ins[15] == "T"
    q = sk[4] + ins + sk[5]
    t = sk[4] + "-" * 16 + sk[5]
    alns = [(5, q, t, 3), (5, q, t, 2)]   # identical -> must pre-merge
    enc = encode_windows_np([alns], [len(sk)])
    b0 = enc.chains["b0"]
    assert b0.dtype == np.int32 and (b0 < 0).any(), b0
    agg = aggregate_device(enc)
    tables = assemble_window_tables(enc, agg, [len(sk)])
    _tables_equal(tables[0], extract_window_tables(len(sk), alns))
    got = window_consensus_via_device([sk], [alns])
    assert got == [_oracle(sk, alns)]


def test_device_empty_and_deletion_only():
    sk = "ACGTACGT"
    cases = [
        [],
        [(1, "--------", "ACGTACGT", 2)],
        [(1, "ACGTACGT", "ACGTACGT", 1),
         (1, "----", "ACGT", 4)],
    ]
    for alns in cases:
        got = window_consensus_via_device([sk], [alns])
        assert got == [_oracle(sk, alns)], alns


# ------------- native encoder / reduced-merge parity -------------


def _mk_alignments(rng, backbone, n, err=0.15):
    from aligngraph2_tpu.align.records import Alignment
    L = len(backbone)
    alns = []
    for _ in range(n):
        ln = int(rng.integers(50, max(60, L // 2)))
        rb = int(rng.integers(0, L - ln))
        t = backbone[rb:rb + ln]
        qs, ts = [], []
        for ch in t:
            r = rng.random()
            if r < err * 0.4:
                qs.append(BASES[rng.integers(0, 4)]); ts.append(ch)
            elif r < err * 0.7:
                qs.append("-"); ts.append(ch)
            elif r < err:
                qs.append(BASES[rng.integers(0, 4)]); ts.append("-")
                qs.append(ch); ts.append(ch)
            else:
                qs.append(ch); ts.append(ch)
        q = "".join(qs)
        alns.append(Alignment(
            query_name="r", ref_name="b", forward=True,
            score=ln - int(err * ln * rng.random()),
            qb=0, qe=sum(c != "-" for c in q), qsize=ln,
            rb=rb, re=rb + ln, rsize=L, qstr=q, tstr="".join(ts)))
    return alns


def test_native_encoder_matches_spec(rng):
    from aligngraph2_tpu.consensus.device import _encode_spec
    from aligngraph2_tpu.consensus.native import encode_windows_native
    backbone = "".join(BASES[i] for i in rng.integers(0, 4, 900))
    alns = _mk_alignments(rng, backbone, 60)
    window, top_k, alpha = 250, 20, 50
    enc_c = encode_windows_native(backbone, alns, window, top_k, alpha)
    if enc_c is None:
        pytest.skip("native toolchain unavailable")
    nw = (len(backbone) + window - 1) // window
    lens = [min(window, len(backbone) - i * window) for i in range(nw)]
    enc_py = _encode_spec(backbone, alns, window, top_k, alpha, lens)
    assert enc_c.n_windows == enc_py.n_windows
    assert enc_c.window_stride == enc_py.window_stride
    np.testing.assert_array_equal(enc_c.ops, enc_py.ops)
    np.testing.assert_array_equal(enc_c.col2seg, enc_py.col2seg)
    np.testing.assert_array_equal(enc_c.seg_win, enc_py.seg_win)
    np.testing.assert_array_equal(enc_c.seg_start, enc_py.seg_start)
    np.testing.assert_array_equal(enc_c.seg_weight, enc_py.seg_weight)
    np.testing.assert_array_equal(enc_c.seg_off, enc_py.seg_off)
    np.testing.assert_array_equal(enc_c.win_col_off, enc_py.win_col_off)
    np.testing.assert_array_equal(enc_c.win_exit, enc_py.win_exit)
    for f in enc_py.chains:
        np.testing.assert_array_equal(enc_c.chains[f], enc_py.chains[f],
                                      err_msg=f)


def test_full_device_path_matches_host_core(rng):
    """consensus_backbone via device backend == host C++ core == python
    spec, on a multi-window backbone."""
    import os
    from aligngraph2_tpu.config import ConsensusConfig
    from aligngraph2_tpu.consensus.window import consensus_backbone
    from aligngraph2_tpu.align.records import AlignmentSet
    backbone = "".join(BASES[i] for i in rng.integers(0, 4, 1500))
    alns = AlignmentSet(_mk_alignments(rng, backbone, 120))
    cfg = ConsensusConfig()
    cfg.window = 400
    cfg.top_k = 40
    cfg.alpha = 60
    outs = {}
    for backend in ("native", "device"):
        os.environ["ALIGNGRAPH2_TPU_CONSENSUS"] = backend
        try:
            outs[backend] = consensus_backbone(backbone, alns, cfg,
                                               threads=2)
        finally:
            del os.environ["ALIGNGRAPH2_TPU_CONSENSUS"]
    os.environ["ALIGNGRAPH2_TPU_NO_NATIVE"] = "1"
    try:
        outs["python"] = consensus_backbone(backbone, alns, cfg,
                                            threads=1)
    finally:
        del os.environ["ALIGNGRAPH2_TPU_NO_NATIVE"]
    assert outs["native"] == outs["python"]
    assert outs["device"] == outs["native"]
