"""Sensitivity study evidencing the recovered mecat2ref+ semantics.

The mecat2ref+ binary is an absent submodule (SURVEY.md §2.5 C2), so its
alpha/beta/delta behavior was recovered from the CLI contract and the
published description (/root/reference/README.md:43-51: candidate blocks
of the similar genome are ranked by a k-mer scoring function clamped to
[alpha, beta]; alignments scoring under delta are dropped).  This bench
demonstrates the recovery behaves AS DESCRIBED, quantitatively:

  * alpha (lower clamp) lifts weakly-seeded candidates: read->ref recall
    on highly diverged genome regions must rise with alpha while
    low-divergence recall stays flat.
  * delta prunes sub-best alignments: mean alignments/read must fall as
    delta rises, with best-locus recall unaffected.

Dataset: a genome whose "similar genome" alternates 100 kb regions of
low (LOW_DIV=1%) and high (HIGH_DIV=20%) divergence; reads are sampled from the TRUE
genome with recorded positions, so recall = fraction of reads whose
emitted read->ref alignment covers the true locus (±5 kb slack for
divergence indel drift).

Prints one JSON line per configuration and writes BENCH_MECATPLUS.json;
the summary table lives in PARITY.md.
"""

import json
import os
import sys
import time

import numpy as np


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from aligngraph2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REGION = int(os.environ.get("AGV_SWEEP_REGION", 100_000))
GENOME_LEN = int(os.environ.get("AGV_SWEEP_GENOME", 2_000_000))
LOW_DIV, HIGH_DIV = 0.01, 0.20
N_DUPS = 8          # segmental duplications -> sub-best alignments so
DUP_LEN = 50_000    # the delta filter has something to prune


def build_dataset(seed=11, coverage=4, mean_read=9000, read_err=0.12):
    from tests.synth import mutate, random_genome, revcomp
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, GENOME_LEN)
    # region-alternating divergence
    sim_parts = []
    for i, lo in enumerate(range(0, GENOME_LEN, REGION)):
        div = HIGH_DIV if i % 2 else LOW_DIV
        sim_parts.append(mutate(rng, genome[lo:lo + REGION], sub=div,
                                ins=div / 4, dele=div / 4))
    similar = "".join(sim_parts)
    # segmental duplications in the similar genome: copies of low-div
    # TRUE-genome segments with extra 3% divergence, so reads from those
    # segments align both to their true locus (best) and to the copy
    # (sub-best) — the delta threshold decides whether the copy survives
    sim = list(similar)
    for d in range(N_DUPS):
        src = (2 * d) * REGION + 10_000          # inside a low-div region
        dst = int(rng.integers(0, len(sim) - DUP_LEN))
        copy = mutate(rng, genome[src:src + DUP_LEN], sub=0.03,
                      ins=0.0075, dele=0.0075)[:DUP_LEN]
        sim[dst:dst + len(copy)] = list(copy)
    similar = "".join(sim)
    reads, positions = [], []
    n_bases = int(GENOME_LEN * coverage)
    total, i = 0, 1
    while total < n_bases:
        ln = max(1000, int(rng.normal(mean_read, mean_read / 4)))
        ln = min(ln, GENOME_LEN)
        start = int(rng.integers(0, GENOME_LEN - ln + 1))
        seq = genome[start:start + ln]
        if rng.random() < 0.5:
            seq = revcomp(seq)
        seq = mutate(rng, seq, sub=read_err, ins=read_err / 2,
                     dele=read_err / 2)
        reads.append((str(i), seq))
        positions.append((start, start + ln))
        total += ln
        i += 1
    return genome, similar, reads, np.array(positions)


def run_config(ref_db, read_db, positions, alpha, beta, delta, **over):
    from aligngraph2_tpu.align.aligner import LongReadAligner
    from aligngraph2_tpu.config import AlignerConfig
    cfg = AlignerConfig()
    cfg.alpha, cfg.beta, cfg.delta = alpha, beta, delta
    for k_, v_ in over.items():
        setattr(cfg, k_, v_)
    t0 = time.time()
    alns = LongReadAligner(ref_db, cfg).align_reads(read_db)
    wall = time.time() - t0
    n_reads = len(read_db)
    per_read = {}
    hit = np.zeros(n_reads + 1, bool)
    for a in alns:
        rid = int(a.query_name)
        per_read[rid] = per_read.get(rid, 0) + 1
        true_lo, true_hi = positions[rid - 1]
        mid = (true_lo + true_hi) / 2
        if a.rb - 5000 <= mid <= a.re + 5000:
            hit[rid] = True
    # region class of each read by its true midpoint
    mids = positions.mean(axis=1)
    high = ((mids // REGION) % 2).astype(bool)
    rid_hit = hit[1:n_reads + 1]
    res = {
        "alpha": alpha, "beta": beta, "delta": delta,
        "recall_low_div": (float(rid_hit[~high].mean())
                           if (~high).any() else None),
        "recall_high_div": (float(rid_hit[high].mean())
                            if high.any() else None),
        "mean_alns_per_read": float(len(alns) / n_reads),
        "aligned_reads_frac": float((np.array(
            [per_read.get(r, 0) for r in range(1, n_reads + 1)]) > 0)
            .mean()),
        "wall_s": round(wall, 1),
    }
    print(json.dumps(res), flush=True)
    return res


def build_pressure_dataset(seed=17, n_copies=12, seg_len=50_000,
                           coverage=6, mean_read=9000, read_err=0.12,
                           src_div=0.15):
    """Candidate-PRESSURE dataset (VERDICT r3 #6 / PARITY.md TODO): one
    TRUE-genome segment whose similar-genome locus is DIVERGED
    (``src_div``) plus ``n_copies`` copies of that same segment
    scattered through the similar genome — n_copies-1 at 3% divergence
    and ONE exact copy (the dominant repeat whose seed count sets the
    prune bar; the beta cap bounds its influence).  Reads sampled from
    the segment see many strongly-seeded repeat candidates crowding one
    weakly-seeded true locus: the regime where the alpha/beta clamp
    decides which candidates get extended."""
    from tests.synth import mutate, random_genome, revcomp
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, GENOME_LEN)
    src = REGION + 20_000
    src_chunk = src // REGION
    sim_parts = []
    for i, lo in enumerate(range(0, GENOME_LEN, REGION)):
        div = src_div if i == src_chunk else LOW_DIV
        sim_parts.append(mutate(rng, genome[lo:lo + REGION], sub=div,
                                ins=div / 4, dele=div / 4))
    sim = list("".join(sim_parts))
    for d in range(n_copies):
        dst = int(rng.integers(0, len(sim) - seg_len))
        if abs(dst - src) < 2 * seg_len:
            dst = (dst + 4 * seg_len) % (len(sim) - seg_len)
        if d == 0:
            copy = genome[src:src + seg_len]        # exact: dominant
        else:
            copy = mutate(rng, genome[src:src + seg_len], sub=0.03,
                          ins=0.0075, dele=0.0075)[:seg_len]
        sim[dst:dst + len(copy)] = list(copy)
    similar = "".join(sim)
    # reads: dense over the source segment, sparse elsewhere
    reads, positions = [], []
    i = 1
    total, budget = 0, int(seg_len * coverage)
    while total < budget:
        ln = max(2000, int(rng.normal(mean_read, mean_read / 4)))
        start = src + int(rng.integers(0, max(seg_len - ln, 1)))
        seq = genome[start:start + ln]
        if rng.random() < 0.5:
            seq = revcomp(seq)
        seq = mutate(rng, seq, sub=read_err, ins=read_err / 2,
                     dele=read_err / 2)
        reads.append((str(i), seq))
        positions.append((start, start + ln))
        total += ln
        i += 1
    return genome, similar, reads, np.array(positions), src, seg_len


def pressure_sweep():
    """Sweep alpha/beta under candidate pressure with a small
    max_candidates; recall = fraction of segment reads whose emitted
    alignment covers the TRUE (diverged) locus."""
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    genome, similar, reads, positions, src, seg_len = \
        build_pressure_dataset()
    ref_db = SeqDatabase([("ref0", similar)])
    read_db = SeqDatabase(reads)
    # Operating point where EXTENSION decides the outcome: delta=0 so
    # emission keeps whatever was extended (delta's own effect is
    # evidenced by the main sweep), candidate_prune FIXED at 0.25
    # (decoupled from delta) so the clamp-vs-bar interaction is
    # isolated, and max_candidates above the copy count so selection
    # pressure comes from the prune bar, not the cap.  Recall == the
    # true diverged locus survived the bar and was extended.
    print(f"# pressure: {len(reads)} reads over a {seg_len//1000} kb "
          f"segment with 12 repeat copies (one exact); delta=0 "
          f"prune=0.25 max_candidates=16", flush=True)
    rows = []
    for alpha, beta in ((0.0, 2.0), (0.5, 2.0), (1.0, 2.0),
                        (0.25, 1e9), (0.25, 1.0), (0.0, 1e9)):
        r = run_config(ref_db, read_db, positions, alpha, beta, 0.0,
                       max_candidates=16, candidate_prune=0.25)
        r["pressure"] = True
        r["max_candidates"] = 16
        r["candidate_prune"] = 0.25
        rows.append(r)
    return rows


def main():
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    genome, similar, reads, positions = build_dataset()
    ref_db = SeqDatabase([("ref0", similar)])
    read_db = SeqDatabase(reads)
    print(f"# {len(reads)} reads, {GENOME_LEN/1e6:.0f} Mb genome, "
          f"regions {LOW_DIV}/{HIGH_DIV} divergence", flush=True)
    results = []
    # alpha sweep (vanilla mecat2ref ~ alpha=0: no lifting)
    for alpha in (0.0, 0.25, 0.5, 1.0):
        results.append(run_config(ref_db, read_db, positions,
                                  alpha, 2.0, 0.9))
    # beta: cap off vs default
    results.append(run_config(ref_db, read_db, positions, 0.5, 1e9, 0.9))
    # delta sweep
    for delta in (0.5, 1.0):
        results.append(run_config(ref_db, read_db, positions,
                                  0.5, 2.0, delta))
    # candidate-pressure sweep: where alpha/beta change OUTCOMES
    results.extend(pressure_sweep())
    with open("BENCH_MECATPLUS.json", "w") as f:
        json.dump(results, f, indent=1)
    print("# wrote BENCH_MECATPLUS.json", flush=True)


if __name__ == "__main__":
    main()
