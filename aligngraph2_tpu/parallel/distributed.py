"""Multi-host orchestration: jax.distributed init + host-level data
sharding.

The reference is single-node (SURVEY.md §2.6 — std::thread only); this
scaling model adds a host dimension (SURVEY.md §5
"Distributed communication backend"):

  * every host calls :func:`init_distributed` once (coordinator
    address/rank from args or the standard cluster env vars JAX already
    auto-detects);
  * input reads are sharded BY HOST with :func:`host_shard` — each host
    reads only its slice of the FASTQ (the multi-host replacement for
    the reference's per-group directory splitting);
  * per-host alignment/graph partials are merged with the collective
    helpers in parallel/sharded.py (all_gather/psum over the global
    mesh).

Single-host runs skip all of this: every helper degrades to a no-op
when jax.process_count() == 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     initialization_timeout: Optional[int] = None,
                     heartbeat_timeout_seconds: Optional[int] = None
                     ) -> int:
    """Initialize jax.distributed (idempotent; no-op if single-host).

    With no arguments JAX auto-detects the cluster environments it
    knows (SLURM, Open MPI); elsewhere pass coordinator_address,
    num_processes and process_id.  Returns the process id.

    The two timeout knobs guard against peer eviction under host
    oversubscription: JAX's defaults (300 s init, 100 s heartbeat) evict
    a worker that gets CPU-starved past the window, which then surfaces
    as a coordination-barrier failure mid-pipeline (the
    test_distributed_2proc flake under full-suite load)."""
    import jax
    if num_processes is not None and num_processes <= 1:
        return 0
    kw = {}
    if initialization_timeout is not None:
        kw["initialization_timeout"] = initialization_timeout
    if heartbeat_timeout_seconds is not None:
        kw["heartbeat_timeout_seconds"] = heartbeat_timeout_seconds
    try:
        if coordinator_address is not None or num_processes is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id, **kw)
        else:
            jax.distributed.initialize(**kw)
    except (RuntimeError, ValueError):
        # already initialized, or no cluster environment detected
        pass
    return jax.process_index()


def host_shard(n_items: int, process_id: Optional[int] = None,
               num_processes: Optional[int] = None) -> slice:
    """The contiguous slice of a length-n work list owned by this host.

    Hosts get near-equal contiguous slices (first ``n % p`` hosts get one
    extra), so a FASTQ can be streamed once per host with skip/stop
    bounds instead of a full parse."""
    import jax
    p = num_processes if num_processes is not None else jax.process_count()
    i = process_id if process_id is not None else jax.process_index()
    if p <= 1:
        return slice(0, n_items)
    base, extra = divmod(n_items, p)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return slice(start, stop)


def host_shard_ids(n_items: int, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> np.ndarray:
    """host_shard as an index array (for fancy-indexed databases)."""
    s = host_shard(n_items, process_id, num_processes)
    return np.arange(s.start, s.stop, dtype=np.int64)


def gather_host_bytes(data: bytes) -> list:
    """All-gather one bytes blob per host -> list of every host's blob
    (process order).  Single-host: [data].  Pads to the max length and
    rides jax.experimental.multihost_utils.process_allgather."""
    import jax
    if jax.process_count() <= 1:
        return [data]
    from jax.experimental import multihost_utils
    n = np.array([len(data)], np.int64)
    sizes = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    m = max(int(sizes.max()), 1)
    arr = np.zeros(m, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(arr))
    gathered = gathered.reshape(len(sizes), m)
    return [gathered[p, :int(sizes[p])].tobytes()
            for p in range(len(sizes))]


def gather_alignments(alns) -> "AlignmentSet":
    """Merge per-host AlignmentSets across hosts (process order, so the
    result is deterministic).  Single-host: identity.

    The interchange is the 3-line .ref text itself — the same format the
    stages already persist, so serialization is one code path
    (align/records.py)."""
    import jax
    if jax.process_count() <= 1:
        return alns
    from ..align.records import AlignmentSet
    blobs = gather_host_bytes(alns.to_ref_text().encode())
    out = AlignmentSet()
    for blob in blobs:
        for a in AlignmentSet.from_ref_text(blob.decode()):
            out.append(a)
    return out


def is_coordinator() -> bool:
    import jax
    return jax.process_index() == 0


def barrier(name: str) -> None:
    """Cross-host sync point (no-op single-host): coordinator-written
    stage files are visible before other hosts read them."""
    import jax
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def merge_host_counts(local_codes: np.ndarray, local_counts: np.ndarray,
                      k: int, dense_max: int = 1 << 26):
    """Merge per-host sparse k-mer counts into the global solid-set input.
    Single-host: identity.

    Dense path (4^k <= dense_max): each host scatters its counts into a
    dense table, contributes it as one row of a device-global array
    (zero rows for its other local devices), and a device reduction over
    the host axis sums the tables — the collective rides the device
    interconnect, not the host network.  Sparse path (k = 14 production default is 1 GB
    dense, so this is the real path): (codes, counts) blobs gathered via
    :func:`gather_host_bytes` and merged on every host."""
    import jax
    if jax.process_count() <= 1:
        return local_codes, local_counts
    size = 1 << (2 * k)
    if size <= dense_max:
        from jax.experimental import multihost_utils
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("d",))
        n_local = jax.local_device_count()
        dense = np.zeros((n_local, size), np.int32)
        np.add.at(dense[0], local_codes, local_counts.astype(np.int32))
        garr = multihost_utils.host_local_array_to_global_array(
            dense, mesh, P("d", None))
        out = jax.jit(lambda a: a.sum(0),
                      out_shardings=NamedSharding(mesh, P()))(garr)
        arr = np.asarray(out.addressable_shards[0].data).reshape(-1)
        codes = np.flatnonzero(arr)
        return codes.astype(np.int64), arr[codes].astype(np.int64)
    # sparse path: bytes gather (host blob sizes differ per host, which
    # process_allgather cannot carry directly)
    blob = (np.int64(len(local_codes)).tobytes()
            + np.ascontiguousarray(local_codes, np.int64).tobytes()
            + np.ascontiguousarray(local_counts, np.int64).tobytes())
    from ..ops.kmer import _merge_counts
    codes = np.zeros(0, np.int64)
    counts = np.zeros(0, np.int64)
    for b in gather_host_bytes(blob):
        n = int(np.frombuffer(b[:8], np.int64)[0])
        c = np.frombuffer(b[8:8 + 8 * n], np.int64)
        m = np.frombuffer(b[8 + 8 * n:8 + 16 * n], np.int64)
        codes, counts = _merge_counts(codes, counts, c, m)
    return codes, counts
