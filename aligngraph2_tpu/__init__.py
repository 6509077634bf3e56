"""aligngraph2_tpu — a JAX similar-genome-assisted reassembly framework.

A from-scratch JAX/XLA/CUDA re-design of the capabilities of AlignGraph2
(reference: Godotcoffee/AlignGraph2): given PacBio long reads, draft contigs,
and a published genome of a similar species, extend and refine the contigs.

Layer map (see SURVEY.md for the reference analysis this was built against):

  cli / pipeline   -- stage DAG with content-addressed caching
                      (replaces AlignGraph2.py + script/saved_helper.py)
  align / ops      -- seed-extend long-read aligner: host seeding, a CUDA
                      extension kernel on the GPU (replaces the external
                      mecat2ref / mecat2ref+ / nucmer binaries)
  graph / traverse -- positional A-Bruijn graph as structure-of-arrays with
                      sort/segment-reduce merges + greedy traversal
                      (replaces PAGraph/src/tools/{graph,position,node})
  consensus        -- windowed partial-order-alignment consensus
                      (replaces PAGraph/src/tools/cns + pa_cns)
  io / coords      -- sequence databases, 2-bit codes, flat coordinate algebra
                      (replaces PAGraph/src/tools/{seq,kmer,align} data model)
  parallel         -- jax.sharding mesh; genome-block-sharded index; reads
                      data-parallel; collective merges across devices
"""

__version__ = "0.1.0"


def _tune_host_allocator() -> None:
    """Keep large freed blocks in the heap instead of munmapping them.

    The pipeline's host side (numpy SoA tables, alignment batches)
    allocates and frees many multi-MB arrays; with glibc's default
    M_MMAP_THRESHOLD each one is a fresh mmap whose first-touch page
    faults dominate on virtualized/sandboxed hosts (measured ~300us per
    4K page under this project's target environment — 2s to touch a
    24 MB array).  Raising the mmap/trim thresholds makes the arena
    reusable: the fault cost is paid once per high-water mark.  Set
    ALIGNGRAPH2_TPU_NO_MALLOPT=1 to opt out."""
    import os
    if os.environ.get("ALIGNGRAPH2_TPU_NO_MALLOPT") == "1":
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        # mallopt's value is a C int, so the largest representable
        # threshold is INT_MAX (~2 GB); that already keeps the GB-scale
        # merge scratch (native/ingest.cpp works on ~1.2 GB blocks at
        # 50M positions) heap-resident instead of re-paying first-touch
        # faults on every mmap/munmap cycle.
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
    except (OSError, ctypes.ArgumentError):
        pass


_tune_host_allocator()
