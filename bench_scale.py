"""Multi-chromosome scale benchmark: N independent chromosomes through
the FULL pipeline (exercises multi-reference grouping, per-group graphs,
and the block-sharded index at multiples of the 5 Mb bench).

Usage: python bench_scale.py [--chroms 4] [--mb 5] [--coverage 8]
Prints one JSON line (same shape as bench_e2e.py) and appends it to
BENCH_SCALE.json.
"""

import argparse
import json
import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from aligngraph2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def make_inputs(n_chroms, mb, coverage, seed, d, profile="legacy"):
    os.makedirs(d, exist_ok=True)
    paths = {n: os.path.join(d, f) for n, f in
             (("reads", "reads.fq"), ("ctg", "ctg.fa"),
              ("genome", "genome.fa"), ("truth", "truth.fa"))}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    from aligngraph2_tpu.io.fasta import write_fasta, write_fastq
    from tests.synth import make_dataset
    reads, ctgs, sims, truths = [], [], [], []
    rid = 0
    # pacbio: repeat-laden chromosomes + indel-dominant 13% error,
    # log-normal lengths, chimeras (tests/synth.py; VERDICT r4 #3)
    err = 0.13 if profile == "pacbio" else 0.1
    for c in range(n_chroms):
        ds = make_dataset(seed=seed + c, genome_len=int(mb * 1e6),
                          coverage=coverage, mean_read=9000,
                          read_err=err, similar_div=0.01,
                          n_contigs=max(2, int(mb * 4)),
                          contig_gap=2000, profile=profile)
        for name, seq in ds["reads"]:
            rid += 1
            reads.append((str(rid), seq))
        for name, seq in ds["contigs"]:
            ctgs.append((f"c{c}_{name}", seq))
        sims.append((f"chr{c}", ds["similar"][0][1]))
        truths.append((f"truth{c}", ds["genome"]))
    write_fastq(paths["reads"], reads)
    write_fasta(paths["ctg"], ctgs)
    write_fasta(paths["genome"], sims)
    write_fasta(paths["truth"], truths)
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--mb", type=float, default=5.0)
    ap.add_argument("--coverage", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rescue", action="store_true",
                    help="two-level read->ref seeding "
                         "(AlignerConfig.ref_seed_rescue)")
    ap.add_argument("--profile", default="legacy",
                    choices=["legacy", "pacbio"])
    args = ap.parse_args()
    tag = f"{args.chroms}x{args.mb:g}mb_c{args.coverage}_s{args.seed}"
    if args.profile != "legacy":
        tag += f"_{args.profile}"
    data = os.path.join("/tmp", f"agv_scale_{tag}")
    out = os.path.join("/tmp", f"agv_scale_out_{tag}")
    t0 = time.time()
    paths = make_inputs(args.chroms, args.mb, args.coverage, args.seed,
                        data, profile=args.profile)
    gen_s = time.time() - t0

    from aligngraph2_tpu.config import PipelineConfig
    from aligngraph2_tpu.pipeline.driver import run_pipeline
    cfg = PipelineConfig()
    cfg.aligner.ref_seed_rescue = args.rescue
    t0 = time.time()
    res = run_pipeline(paths["reads"], paths["ctg"], paths["genome"],
                       out, cfg)
    wall = time.time() - t0
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    n_reads = metrics.get("n_reads", 0)
    line = {
        "metric": "pipeline_reads_per_s",
        "value": round(n_reads / wall, 3) if wall else 0,
        "unit": "reads/s",
        "wall_s": round(wall, 2),
        "gen_s": round(gen_s, 2),
        "stage_s": metrics.get("stage_s"),
        "stage_rss_mb": metrics.get("stage_rss_mb"),
        "n_reads": n_reads,
        "n_groups": metrics.get("n_groups"),
        "n_chains": metrics.get("n_chains"),
        "rss_mb": metrics.get("stage_rss_mb", {}).get("emit"),
        "dataset": tag,
        "total_mb": args.chroms * args.mb,
        "rescue": args.rescue,
        "profile": args.profile,
    }
    print(json.dumps(line), flush=True)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_SCALE.json"), "a") as f:
        f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
