"""K-mer encoding and the solid-k-mer counter.

Replaces the reference ``kmer_counter`` stage and KmerHelper
(/root/reference/PAGraph/src/main/kmer_counter.cpp,
/root/reference/PAGraph/src/tools/kmer/KmerHelper.cpp):

  * big-endian rolling 2-bit codes: code(s[i..i+k)) with A=0 C=1 G=2 T=3,
    non-ACGT treated as A (KmerHelper.hpp acgt()),
  * a dense 4^k abundance table (k <= 15),
  * the cutoff rule: the smallest abundance value ``a`` such that the
    fraction of table entries with abundance > a is <= threshold
    (kmer_counter.cpp:58-77); all codes with abundance >= a are "solid".

The device path batches reads into padded (B, L) uint8 tensors, computes
codes with k fused shift-or steps, and scatter-adds into the table; invalid
(padding) positions are routed to a spill slot past the table end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def kmer_codes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Host: uint8 base codes -> int64 k-mer codes (length n-k+1; empty if
    n < k)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    c = codes.astype(np.int64)
    out = np.zeros(n - k + 1, dtype=np.int64)
    for j in range(k):
        out = (out << 2) | c[j:n - k + 1 + j]
    return out


def revcomp_code_np(code: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of 2-bit codes (host utility)."""
    code = np.asarray(code, dtype=np.int64)
    out = np.zeros_like(code)
    c = code.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out


def code_to_str(code: int, k: int) -> str:
    """Code -> k-mer string (KmerHelper::code2Kmer)."""
    table = "ACGT"
    out = []
    for _ in range(k):
        out.append(table[code & 3])
        code >>= 2
    return "".join(reversed(out))


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_codes_batch(batch: jax.Array, lengths: jax.Array, k: int):
    """Device: (B, L) uint8 codes + (B,) lengths -> ((B, L-k+1) int32 codes,
    (B, L-k+1) bool valid mask).

    Requires 4^k < 2^31 (k <= 15, enforced by config validation — same
    bound as the reference's dense table).
    """
    B, L = batch.shape
    n_pos = L - k + 1
    c = batch.astype(jnp.int32)
    out = jnp.zeros((B, n_pos), dtype=jnp.int32)
    for j in range(k):
        out = (out << 2) | jax.lax.dynamic_slice_in_dim(c, j, n_pos, axis=1)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, n_pos), 1)
    valid = pos < (lengths.astype(jnp.int32)[:, None] - (k - 1))
    return out, valid


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _accumulate(table: jax.Array, batch: jax.Array, lengths: jax.Array,
                k: int) -> jax.Array:
    codes, valid = kmer_codes_batch(batch, lengths, k)
    # Route padding to the spill slot (index 4^k) so one scatter-add does
    # the whole batch with no host-side masking.
    spill = table.shape[0] - 1
    idx = jnp.where(valid, codes, spill).reshape(-1)
    return table.at[idx].add(1, mode="drop")


class KmerCounter:
    """Dense 4^k abundance counter with device scatter-add accumulation."""

    def __init__(self, k: int, device=None):
        if not 1 <= k <= 15:
            raise ValueError("k must be in [1, 15] for the dense table")
        self.k = k
        self.table_size = 1 << (2 * k)
        self._device = device
        with jax.default_device(device) if device is not None else _nullctx():
            self.table = jnp.zeros(self.table_size + 1, dtype=jnp.int32)

    def add_batch(self, batch: np.ndarray, lengths: np.ndarray) -> None:
        self.table = _accumulate(self.table, jnp.asarray(batch),
                                 jnp.asarray(lengths), self.k)

    def counts(self) -> np.ndarray:
        """Host copy of the 4^k table (spill slot dropped)."""
        return np.asarray(self.table[:self.table_size])

    def solid_codes(self, threshold: float = 0.2) -> np.ndarray:
        counts = self.counts()
        min_ab = solid_min_abundance(counts, threshold)
        return np.flatnonzero(counts >= min_ab).astype(np.int64)


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def solid_min_abundance(counts: np.ndarray, threshold: float) -> int:
    """Exact reference cutoff rule (kmer_counter.cpp:58-77).

    Walk distinct abundance values ascending, accumulating how many table
    entries have each; stop at the first abundance where the surviving
    fraction (entries with strictly greater abundance) drops to <=
    threshold.
    """
    table_size = counts.size
    values, freq = np.unique(counts, return_counts=True)
    cum = np.cumsum(freq)
    ok = (1.0 - cum / table_size) <= threshold
    first = int(np.argmax(ok))  # ok is monotone and always true at the end
    return int(values[first])


def count_reads(db, k: int, batch_reads: int = 256,
                max_len: int | None = None) -> KmerCounter:
    """Count all k-mers of every sequence in a SeqDatabase (forward strand
    only, like the reference which counts read strings as stored).

    Device path: scatter-add into the dense table (KmerCounter)."""
    counter = KmerCounter(k)
    n = len(db)
    if n == 0:
        return counter
    order = np.argsort(db.lengths, kind="stable")  # bucket similar lengths
    for s in range(0, n, batch_reads):
        ids = order[s:s + batch_reads]
        cap = int(db.lengths[ids].max()) if max_len is None else max_len
        cap = max(cap, k)
        # round the pad length up to a power of two and the batch up to
        # batch_reads so jit compiles once per bucket, not per batch
        cap = 1 << (cap - 1).bit_length()
        if len(ids) < batch_reads:
            ids = np.pad(ids, (0, batch_reads - len(ids)), mode="edge")
            batch, lens = db.padded_batch(ids, cap)
            lens[len(order) - s:] = 0  # padded rows contribute nothing
        else:
            batch, lens = db.padded_batch(ids, cap)
        counter.add_batch(batch, lens)
    return counter


class SparseCounts:
    """Sorted unique k-mer codes with counts + the dense-table size."""

    def __init__(self, codes: np.ndarray, counts: np.ndarray, k: int):
        self.codes = codes
        self.counts_arr = counts
        self.k = k
        self.table_size = 1 << (2 * k)

    def solid_codes(self, threshold: float = 0.2) -> np.ndarray:
        min_ab = solid_min_abundance_sparse(self.counts_arr,
                                            self.table_size, threshold)
        if min_ab == 0:
            # every table entry (incl. absent k-mers) is "solid" — the
            # reference writes the full 4^k set in this regime
            return np.arange(self.table_size, dtype=np.int64)
        return self.codes[self.counts_arr >= min_ab]


def solid_set(db, k: int, threshold: float = 0.2) -> np.ndarray:
    """The solid-kmer set of a read database — the whole kmer_counter
    stage in one call.

    Native path: single-pass rolling codes + radix sort + the exact
    cutoff rule in C++ (native/seedhits.cpp agk_solid).  Fallback: the
    numpy counter below (the specification; identical output,
    tests/test_native_seed.py)."""
    if len(db):
        from .native import solid_set_native
        starts = db.offsets.astype(np.int64)
        res = solid_set_native(db.codes, starts, k, threshold)
        if res is not None:
            codes, cutoff = res
            if cutoff == 0:
                return np.arange(1 << (2 * k), dtype=np.int64)
            return codes
    return count_reads_sorted(db, k).solid_codes(threshold)


def solid_set_sharded(db, k: int, threshold: float,
                      shard_ids: np.ndarray) -> np.ndarray:
    """Host-sharded kmer_counter (SURVEY.md §2.6 "sharded-state
    parallelism"; single-host hot loop: kmer_counter.cpp:19-96): each
    host counts only its shard of the reads, per-host sparse counts are
    merged across hosts (device reduction when the dense table fits,
    bytes gather otherwise), and the exact cutoff rule runs on the
    merged counts — identical solid set at any host count."""
    from ..parallel.distributed import merge_host_counts
    sc = count_reads_sorted(db, k, ids=shard_ids)
    codes, counts = merge_host_counts(sc.codes, sc.counts_arr, k)
    return SparseCounts(codes, counts, k).solid_codes(threshold)


def count_reads_sorted(db, k: int, chunk_bases: int = 256_000_000,
                       ids: np.ndarray | None = None) -> SparseCounts:
    """Sort-based host counter — the scalable path.

    The dense device scatter-add needs a 268M-entry table at k=14;
    sorting the code stream and segment-counting is O(n log n) with
    perfect locality and needs no device round-trips.  Chunks are merged by concatenating (code, count)
    pairs and re-reducing."""
    acc_codes = np.zeros(0, np.int64)
    acc_counts = np.zeros(0, np.int64)

    def reduce_chunk(codes):
        if len(codes) == 0:
            return codes, np.zeros(0, np.int64)
        codes.sort()  # in-place; np.unique would sort a second copy
        boundary = np.empty(len(codes), np.bool_)
        boundary[0] = True
        np.not_equal(codes[1:], codes[:-1], out=boundary[1:])
        idx = np.flatnonzero(boundary)
        cnt = np.diff(np.append(idx, len(codes)))
        return codes[idx], cnt

    buf = []
    buf_bases = 0
    for i in (range(len(db)) if ids is None else ids):
        c = db.get_codes(int(i))
        if len(c) >= k:
            buf.append(kmer_codes_np(c, k))
            buf_bases += len(c)
        if buf_bases >= chunk_bases:
            u, n = reduce_chunk(np.concatenate(buf))
            acc_codes, acc_counts = _merge_counts(acc_codes, acc_counts,
                                                  u, n)
            buf, buf_bases = [], 0
    if buf:
        u, n = reduce_chunk(np.concatenate(buf))
        acc_codes, acc_counts = _merge_counts(acc_codes, acc_counts, u, n)
    return SparseCounts(acc_codes, acc_counts, k)


def _merge_counts(c1, n1, c2, n2):
    if len(c1) == 0:
        return c2, n2
    codes = np.concatenate([c1, c2])
    counts = np.concatenate([n1, n2])
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    counts = counts[order]
    boundary = np.concatenate([[True], codes[1:] != codes[:-1]])
    seg = np.cumsum(boundary) - 1
    out_counts = np.bincount(seg, weights=counts).astype(np.int64)
    return codes[boundary], out_counts


def solid_min_abundance_sparse(counts: np.ndarray, table_size: int,
                               threshold: float) -> int:
    """The reference cutoff rule over sparse counts: absent table entries
    are abundance-0 entries."""
    values, freq = np.unique(counts, return_counts=True)
    zero_entries = table_size - len(counts)
    if zero_entries > 0:
        values = np.concatenate([[0], values])
        freq = np.concatenate([[zero_entries], freq])
    cum = np.cumsum(freq)
    ok = (1.0 - cum / table_size) <= threshold
    first = int(np.argmax(ok))
    return int(values[first])


# --- solid-kmer set file (binary interchange, format-compatible with the
# reference: [size_t k][uint64 codes...], kmer_counter.cpp:87-95) ----------

def write_solid_set(path: str, k: int, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.array([k], dtype=np.uint64).tofile(f)
        codes.astype(np.uint64).tofile(f)


def read_solid_set(path: str) -> tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        k = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        codes = np.fromfile(f, dtype=np.uint64).astype(np.int64)
    return k, codes
