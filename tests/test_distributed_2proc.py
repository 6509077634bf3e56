"""REAL multi-process distributed execution (VERDICT r2 missing #3/#4).

Two OS processes initialize jax.distributed against a local coordinator
(CPU backend, gloo collectives) and run the full pipeline into a shared
out_dir; every n_hosts>1 branch in pipeline/driver.py executes for real:
host-sharded k-mer counting + cross-host count merge (stage 1),
host-sharded reads + gather_alignments (stages 2/3/7), group sharding +
gather_host_bytes result merge (stage 6), backbone sharding (stage 8),
coordinator-only writes + barriers throughout.  The final outputs must be
byte-identical to a single-process run.

The reference has no distributed anything (SURVEY.md §2.6); this surface
is our own commitment (SURVEY.md §5 "Distributed communication backend").
"""

import os
import socket
import subprocess
import sys

import pytest

from tests.synth import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nprocs: int, data_dir: str, out_dir: str,
                 timeout: float = 1800.0, sharded: bool = False) -> None:
    # generous timeout: the two cooperating workers share this host's
    # cores with whatever else the suite is running; 600 s flaked under
    # full-suite load while the test passes standalone in ~270 s (the
    # worker also raises JAX's heartbeat timeout — the flake's root
    # cause was heartbeat eviction of a CPU-starved peer)
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)   # worker sets cpu itself before import
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_dist_worker.py"),
         str(r), str(nprocs), str(port), data_dir, out_dir,
         "1" if sharded else "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nprocs)]
    outs = []
    failed = False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed = True
        outs.append(out)
        failed = failed or p.returncode != 0
    assert not failed, "worker failed:\n" + "\n====\n".join(
        o[-3000:] for o in outs)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from aligngraph2_tpu.io.fasta import write_fasta, write_fastq
    ds = make_dataset(seed=11, genome_len=30000, coverage=10,
                      mean_read=1200, read_err=0.08, n_contigs=3,
                      contig_gap=700)
    d = str(tmp_path_factory.mktemp("dist_data"))
    write_fastq(os.path.join(d, "reads.fq"), ds["reads"])
    write_fasta(os.path.join(d, "ctg.fa"), ds["contigs"])
    write_fasta(os.path.join(d, "genome.fa"), ds["similar"])
    return d


OUTPUTS = ("final.fasta", "remainder.fasta", "exclude.fasta", "add.fasta",
           "connect_info.txt")


def test_two_process_pipeline_matches_single(tmp_path, data_dir):
    out1 = str(tmp_path / "out1")
    out2 = str(tmp_path / "out2")
    _run_workers(1, data_dir, out1)
    _run_workers(2, data_dir, out2)
    for name in OUTPUTS:
        p1, p2 = os.path.join(out1, name), os.path.join(out2, name)
        assert os.path.exists(p2), f"{name} missing from 2-process run"
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read(), f"{name} differs at 2 processes"
    # stage-1 host-sharded counting produced the identical solid set
    s1 = os.path.join(out1, "working_dir", "solid_kmer_set.bin")
    s2 = os.path.join(out2, "working_dir", "solid_kmer_set.bin")
    with open(s1, "rb") as f1, open(s2, "rb") as f2:
        assert f1.read() == f2.read(), "solid sets differ at 2 processes"


def test_two_process_sharded_align_matches_single(tmp_path, data_dir):
    """Multi-host x device-sharded alignment (VERDICT r4 missing #4):
    2 processes x 4 virtual CPU devices each, runtime.sharded_align=True
    — hosts shard the read files, each host's local mesh shards
    seeds/extension.  Outputs must be byte-identical to a single-process
    run on one 4-device mesh (the sharded aligner is bit-identical for
    any mesh shape, tests/test_sharded_aligner.py; the single-device
    path extends in the static band instead, so it is not the
    comparison here)."""
    out1 = str(tmp_path / "out1")
    out2 = str(tmp_path / "out2")
    _run_workers(1, data_dir, out1, sharded=True)
    _run_workers(2, data_dir, out2, sharded=True)
    for name in OUTPUTS:
        p1, p2 = os.path.join(out1, name), os.path.join(out2, name)
        assert os.path.exists(p2), f"{name} missing from sharded run"
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read(), \
                f"{name} differs (2-proc sharded vs single)"
