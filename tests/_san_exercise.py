"""Sanitizer exercise driver: runs all the native cores on synthetic
data WITHOUT triggering any XLA compilation (XLA:CPU itself aborts under
ASan interceptors, which would mask real findings in our code).  Invoked
by tests/test_sanitizers.py in a subprocess with LD_PRELOAD=libasan and
ALIGNGRAPH2_TPU_NATIVE_DIR pointing at the instrumented builds.

Alignments are constructed exactly (reads/contigs are slices of the
genome) so the graph, traversal (threaded and serial, asserted equal),
assembly and consensus all run on realistic inputs with zero DP.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# stay on the CPU; no jax op is ever executed below, only imported
# transitively
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> None:
    rng = np.random.default_rng(11)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 8000))

    # ---- fastio core: FASTA/FASTQ parse ----
    from aligngraph2_tpu.io.fasta import write_fasta, write_fastq
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    reads = []
    for i, s in enumerate(range(0, len(genome) - 1000, 200)):
        reads.append((f"r{i}", genome[s:s + 1000]))
    read_pos = {f"r{i}": s for i, s in
                enumerate(range(0, len(genome) - 1000, 200))}
    import tempfile
    tmp = tempfile.mkdtemp(prefix="san_ex_")
    rq = os.path.join(tmp, "reads.fq")
    write_fastq(rq, reads)
    read_db = SeqDatabase.from_file(rq)
    assert len(read_db) == len(reads)
    gf = os.path.join(tmp, "g.fa")
    write_fasta(gf, [("ref0", genome)])
    ref_db = SeqDatabase.from_file(gf)

    ctg_bounds = [(400, 3400), (4000, 7000)]
    ctgs = SeqDatabase((f"ctg{i}", genome[a:b])
                       for i, (a, b) in enumerate(ctg_bounds))

    # ---- seedhits core: native hit enumeration ----
    from aligngraph2_tpu.ops.seedextend import SeedIndex
    from aligngraph2_tpu.ops.native import seed_hits_native
    index = SeedIndex(ref_db, 11)
    base_list = [read_db.get_codes(i) for i in range(4)]
    starts = np.zeros(5, np.int64)
    np.cumsum([len(b) for b in base_list], out=starts[1:])
    hits = seed_hits_native(index, np.concatenate(base_list), starts)
    assert hits is not None and len(hits[0]) > 0

    # ---- exact alignments (no DP) ----
    from aligngraph2_tpu.align.records import Alignment, AlignmentSet

    def exact(qn, rn, seq, qsize, rb, rsize):
        return Alignment(query_name=qn, ref_name=rn, forward=True,
                         score=2 * len(seq), qb=0, qe=len(seq),
                         qsize=qsize, rb=rb, re=rb + len(seq),
                         rsize=rsize, qstr=seq, tstr=seq)

    r2c = AlignmentSet()
    r2r = AlignmentSet()
    for name, seq in reads:
        s = read_pos[name]
        r2r.append(exact(name, "ref0", seq, len(seq), s, len(genome)))
        for ci, (a, b) in enumerate(ctg_bounds):
            lo, hi = max(s, a), min(s + len(seq), b)
            if hi - lo >= 400:
                piece = genome[lo:hi]
                al = exact(f"ctg{ci}", "x", piece, len(seq), lo - a, b - a)
                al.query_name, al.ref_name = name, f"ctg{ci}"
                al.qb, al.qe = lo - s, hi - s
                al.qsize = len(seq)
                r2c.append(al)
    c2r = AlignmentSet()
    for ci, (a, b) in enumerate(ctg_bounds):
        c2r.append(exact(f"ctg{ci}", "ref0", genome[a:b], b - a, a,
                         len(genome)))

    # ---- graph build + THREADED traversal (traverse core) ----
    from aligngraph2_tpu.config import GraphConfig
    from aligngraph2_tpu.graph.pagraph import PAGraph
    from aligngraph2_tpu.graph.processor import (GroupSpec,
                                                 PositionProcessor)
    from aligngraph2_tpu.ops.kmer import kmer_codes_np
    from aligngraph2_tpu.traverse.assembly import assemble_group
    from aligngraph2_tpu.traverse.walk import TravelState

    gcfg = GraphConfig(k=12, epsilon=10, min_len=50)
    km = np.concatenate([kmer_codes_np(read_db.get_codes(i), gcfg.k)
                         for i in range(len(read_db))])
    solid = np.unique(km)
    group = GroupSpec("ref0", [("ctg0", True), ("ctg1", True)])

    def run(threads):
        graph = PAGraph(solid, gcfg.k)
        pp = PositionProcessor(graph, read_db, ctgs, ref_db, r2c, r2r,
                               c2r, group, gcfg)
        pp.pre_process()
        pp.process(log=lambda *a: None, threads=threads)
        st = TravelState(graph=graph, ctgs=ctgs, refs=ref_db,
                         ctg_mapper=pp.ctg_mapper,
                         ref_mapper=pp.ref_mapper,
                         deviation=gcfg.epsilon * 2,
                         error_rate=gcfg.error_rate,
                         start_split=gcfg.start_split,
                         min_len=gcfg.min_len, threads=threads)
        return assemble_group(st, group.contigs, None, "s_")

    res_par = run(8)
    res_ser = run(1)
    assert res_par.success == res_ser.success
    assert [c["sequence"] for c in res_par.connections] \
        == [c["sequence"] for c in res_ser.connections]
    assert res_par.connections, "no chain assembled"

    # ---- poacns core: threaded window consensus ----
    from aligngraph2_tpu.config import ConsensusConfig
    from aligngraph2_tpu.consensus.window import consensus_backbone
    ccfg = ConsensusConfig(window=2000, top_k=100, alpha=50)
    cns = consensus_backbone(genome, r2r, ccfg, threads=4)
    assert len(cns) > 0.9 * len(genome)

    print("san exercise ok:", len(res_par.connections), "chains,",
          f"consensus {len(cns)}bp")


if __name__ == "__main__":
    main()
