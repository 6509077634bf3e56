"""Command-line interface, argument-compatible with the reference driver
(/root/reference/AlignGraph2.py:10-46):

    python -m aligngraph2_tpu.cli -r read.fq -c ctg.fa -g genome.fa -o out
        [-m] [-b 200] [--alpha .5] [--beta 2] [--delta .9] [-v 2] [-k 14]
        [--epsilon 10] [-l 50] [-a 10000] [-t 16]

Notes vs the reference:
  * ``-m`` (use mecat2ref+) is accepted for compatibility; the built-in
    seed-extend aligner always applies the alpha/beta/delta semantics, so
    the flag is a no-op.
  * ``-l`` actually reaches the traversal here.  The reference validates
    it but clobbers it when invoking pagraph (AlignGraph2.py:417-424
    passes '-r' twice), so its traversals always ran with min_len=50.
  * ``-b`` is accepted and mapped to the seeding block-shard size
    (kb); the reference validates it but never forwards it
    (AlignGraph2.py:93-95).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aligngraph2_tpu",
        description="Similar genome assisted reassembly pipeline for "
                    "PacBio long reads",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--version", action="version", version="%(prog)s 0.1")
    p.add_argument("-r", "--read", metavar="[fastq]", required=True,
                   help="read path")
    p.add_argument("-c", "--contig", metavar="[fasta]", required=True,
                   help="contig path")
    p.add_argument("-g", "--genome", metavar="[fasta]", required=True,
                   help="reference path")
    p.add_argument("-o", "--output", metavar="[dir]", required=True,
                   help="output directory")
    p.add_argument("-m", action="store_true", default=False,
                   help="customized alignment algorithm (compat no-op)")
    p.add_argument("-b", metavar="[int]", type=int, default=200,
                   help="size of similar genome blocks [50-1000]")
    p.add_argument("--alpha", metavar="[real]", type=float, default=0.5,
                   help="lower bound of k-mer scoring function [0-1]")
    p.add_argument("--beta", metavar="[real]", type=float, default=2.0,
                   help="upper bound of k-mer scoring function [1-inf]")
    p.add_argument("--delta", metavar="[real]", type=float, default=0.9,
                   help="threshold for alignment scoring [0-1]")
    p.add_argument("-v", metavar="[int]", type=int, default=2,
                   dest="cov", help="coverage to filter alignments")
    p.add_argument("-k", metavar="[int]", type=int, default=14,
                   dest="k", help="size of k-mer [4-15]")
    p.add_argument("--epsilon", metavar="[int]", type=int, default=10,
                   help="distance to join two vertices [5-100]")
    p.add_argument("-l", metavar="[int]", type=int, default=50,
                   dest="min_len", help="minimum path length")
    p.add_argument("-a", metavar="[int]", type=int, default=10000,
                   dest="block2", help="size of long read blocks [100-1e5]")
    p.add_argument("-t", metavar="[int]", type=int, default=16,
                   dest="threads", help="thread number")
    p.add_argument("--profile", metavar="[dir]", default=None,
                   help="write a JAX profiler trace of the run here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .config import PipelineConfig
    cfg = PipelineConfig()
    cfg.aligner.alpha = args.alpha
    cfg.aligner.beta = args.beta
    cfg.aligner.delta = args.delta
    # -b arrives in the reference's unit ([50-1000], nominally kb of
    # similar genome per block); it sets the block-sharding granularity
    # of the multi-device seeding path (config.AlignerConfig.block_size)
    cfg.aligner.block_size = args.b * 1000
    cfg.graph.k = args.k
    cfg.graph.epsilon = args.epsilon
    cfg.graph.min_len = args.min_len
    cfg.graph.cov_filter = args.cov
    cfg.consensus.window = args.block2
    cfg.runtime.threads = args.threads
    cfg.runtime.profile_dir = args.profile
    try:
        cfg.validate()
        if not 50 <= args.b <= 1000:
            raise ValueError(
                "Size of similar genome blocks must be [50-1000]")
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    from .pipeline.driver import run_pipeline
    run_pipeline(args.read, args.contig, args.genome, args.output, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
