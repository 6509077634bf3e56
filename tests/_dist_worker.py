"""Subprocess worker for the real multi-process distributed test
(tests/test_distributed_2proc.py): initialize jax.distributed on the CPU
backend and run the full pipeline.  Usage:

    python tests/_dist_worker.py <rank> <nprocs> <port> <data_dir> <out_dir> \
        [sharded]

Every host runs the same call; coordinator-only writes + barriers inside
the driver make the shared out_dir identical to a single-host run.  With
``sharded`` = "1", alignment additionally runs device-sharded over each
host's local 4-device mesh — the multi-host x device-sharded production
combination (hosts shard files, devices shard seeds/extension)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aligngraph2_tpu.utils.compile_cache import enable_compile_cache  # noqa

enable_compile_cache()


def main() -> None:
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    data_dir, out_dir = sys.argv[4], sys.argv[5]
    sharded = len(sys.argv) > 6 and sys.argv[6] == "1"
    if nprocs > 1:
        from aligngraph2_tpu.parallel.distributed import init_distributed
        # generous timeouts: two cooperating workers share the host's
        # cores with the rest of the suite; JAX's 100 s heartbeat default evicted a
        # CPU-starved worker under load (the coordination-barrier flake)
        init_distributed(coordinator_address=f"localhost:{port}",
                         num_processes=nprocs, process_id=rank,
                         initialization_timeout=900,
                         heartbeat_timeout_seconds=900)
    from aligngraph2_tpu.config import PipelineConfig
    from aligngraph2_tpu.pipeline.driver import run_pipeline

    cfg = PipelineConfig()
    # sharded=False: host-sharding only (reads/groups/backbones +
    # gathers); sharded=True: additionally device-shard alignment over
    # each host's local virtual-device mesh — the multi-host x
    # device-sharded combination
    cfg.runtime.sharded_align = sharded
    cfg.runtime.threads = 2
    cfg.runtime.progress = False
    res = run_pipeline(os.path.join(data_dir, "reads.fq"),
                       os.path.join(data_dir, "ctg.fa"),
                       os.path.join(data_dir, "genome.fa"),
                       out_dir, cfg, log=lambda *a: None)
    print(f"rank {rank} done: {res.final_fasta}", flush=True)


if __name__ == "__main__":
    main()
