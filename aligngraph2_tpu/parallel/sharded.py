"""Production sharded alignment: block-sharded genome seeding +
data-parallel banded extension over the (data, block) device mesh.

This is the multi-device path of ``LongReadAligner.align_reads`` (the
single-device path keeps the host seeding + the static-band extension of
ops/extend.py).  It replaces the reference's only scaling mechanisms —
thread-striped read loops (Aligner.tcc:28-29 via MultiThreadTools.tcc:12)
and mecat2ref+'s genome block decomposition (README.md:43-51):

  1. the target genome is chopped into overlapping blocks; each block's
     k-mers are indexed (``build_block_index``) and the index is sharded
     over the ``block`` mesh axis;
  2. SEED step (shard_map over (data, block)): reads are sharded over the
     ``data`` axis; each shard scores its local reads against its local
     blocks — per (read, strand, block) a diagonal-bin hit histogram with
     adjacent-bin smoothing and per-block top-K bins; the per-block
     candidate tables ``all_gather`` over the block axis and a greedy
     near-diagonal dedup + the alpha/beta hit-count clamp (the recovered
     mecat2ref+ ranking, ops/seedextend.py) selects the global top-K
     candidates per read;
  3. the host compacts the (read, candidate) table to LIVE lanes only
     (ragged work the device cannot compact under static shapes — dead
     lanes would otherwise burn up to K x the DP FLOPs) and gathers each
     lane's target window;
  4. EXTEND step (shard_map over ALL devices): adaptive banded DP +
     device traceback (ops/banded_dp.py) on the live lanes.

Outputs are bit-identical for any mesh shape (1x1 .. NxM): the per-block
tables and their gather order do not depend on shard boundaries, host
compaction is deterministic, and extension lanes are independent —
asserted by tests/test_sharded_aligner.py and
__graft_entry__.dryrun_multichip.

Documented deviations from the host seeding path (ops/seedextend.py),
chosen for fixed device shapes:
  * per-bin diagonal estimate is the integer MEAN of member diagonals
    (host: median) — both land within bin_w of the true diagonal and the
    adaptive band absorbs the difference;
  * at most ``occ`` occurrences per (query k-mer, block) are enumerated
    (host: all occurrences up to max_occ).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..io.seqdb import SeqDatabase
from ..ops.banded_dp import banded_align, traceback
from ..ops.kmer import kmer_codes_batch, kmer_codes_np

INT32_MAX = np.iinfo(np.int32).max


class BlockIndex(NamedTuple):
    """Genome split into overlapping blocks with per-block k-mer indexes."""
    blocks: np.ndarray        # (NB, BL) uint8 codes (pad rows = 0)
    block_lens: np.ndarray    # (NB,) int32 (0 for pad rows)
    block_seq: np.ndarray     # (NB,) int32 originating target sequence id
    block_start: np.ndarray   # (NB,) int32 start offset within that
                              # sequence (per-sequence coords < 2^31 — the
                              # same bound as the reference's uint32 flat
                              # coordinate space, PositionMapper.cpp:16-31)
    sorted_codes: np.ndarray  # (NB, L) int32 sorted k-mer codes, pad=INT32_MAX
    sorted_pos: np.ndarray    # (NB, L) int32 in-block k-mer positions
    k: int
    block_len: int
    overlap: int


def build_block_index(db: SeqDatabase, k: int, block_len: int,
                      overlap: int | None = None,
                      pad_blocks_to: int = 1) -> BlockIndex:
    """Chop every target sequence into overlapping blocks and index each
    block's k-mers.  Overlap (default a quarter block) keeps alignments
    near block boundaries findable in at least one block; ``pad_blocks_to``
    pads the block count to a multiple (empty rows) so the arrays shard
    evenly over the block mesh axis."""
    if overlap is None:
        overlap = block_len // 4
    # int32 sorted-code arrays bound the device index to k <= 15
    # (AlignerConfig.seed_k_max defaults to 15 for this reason)
    if k > 15:
        raise ValueError(f"block index supports k <= 15, got {k}")
    stride = max(block_len - overlap, 1)
    pieces = []  # (seq_id, start, codes)
    for i in range(len(db)):
        codes = db.get_codes(i)
        for s in range(0, max(len(codes) - overlap, 1), stride):
            piece = codes[s:s + block_len]
            if len(piece) < k:
                continue
            pieces.append((i, s, piece))
    nb = len(pieces)
    nb_pad = max(((nb + pad_blocks_to - 1) // pad_blocks_to)
                 * pad_blocks_to, pad_blocks_to)
    idx_len = max((len(p) - k + 1 for _, _, p in pieces), default=1)
    blocks = np.zeros((nb_pad, block_len), np.uint8)
    lens = np.zeros(nb_pad, np.int32)
    seq_id = np.zeros(nb_pad, np.int32)
    start = np.zeros(nb_pad, np.int32)
    s_codes = np.full((nb_pad, idx_len), INT32_MAX, np.int32)
    s_pos = np.zeros((nb_pad, idx_len), np.int32)
    for bi, (sid, st, piece) in enumerate(pieces):
        blocks[bi, :len(piece)] = piece
        lens[bi] = len(piece)
        seq_id[bi] = sid
        start[bi] = st
        kc = kmer_codes_np(piece, k)
        order = np.argsort(kc, kind="stable")
        s_codes[bi, :len(kc)] = kc[order]
        s_pos[bi, :len(kc)] = order
    return BlockIndex(blocks, lens, seq_id, start, s_codes, s_pos,
                      k, block_len, overlap)


# ---------------------------------------------------------------------------
# SEED step (device)


def _seed_block_candidates(q_codes, q_valid, sorted_codes, sorted_pos, *,
                           NQ, nbins, bin_w, occ, max_occ, top_t):
    """Per (stream, local block): top-T candidate diagonal bins.

    q_codes/q_valid: (S, NK); sorted_codes/pos: (NB_l, L).
    Returns cnt (S, NB_l, T) int32 smoothed hit counts and
    diag (S, NB_l, T) int32 block-local diagonal estimates.
    """
    S, NK = q_codes.shape
    qpos = jax.lax.broadcasted_iota(jnp.int32, (S, NK), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (S, NK), 0)

    def per_block(sc, sp):
        L = sc.shape[0]
        lo = jax.vmap(lambda qc: jnp.searchsorted(sc, qc))(q_codes)
        hi = jax.vmap(
            lambda qc: jnp.searchsorted(sc, qc, side="right"))(q_codes)
        n = hi - lo
        ok = q_valid & (n > 0) & (n <= max_occ)
        hist = jnp.zeros((S, nbins + 1), jnp.int32)
        dsum = jnp.zeros((S, nbins + 1), jnp.int32)
        for o in range(occ):  # static small unroll
            hit = ok & (o < n)
            tpos = sp[jnp.minimum(lo + o, L - 1)]
            diag = tpos - qpos + NQ  # shifted to >= 0
            b = jnp.clip(diag // bin_w, 0, nbins - 1)
            b = jnp.where(hit, b, nbins)  # spill slot for non-hits
            hist = hist.at[rows, b].add(1)
            dsum = dsum.at[rows, b].add(jnp.where(hit, diag, 0))
        hist, dsum = hist[:, :nbins], dsum[:, :nbins]
        # adjacent-bin pair smoothing (ops/seedextend.py's bin+1 credit)
        zero = jnp.zeros((S, 1), jnp.int32)
        sm_h = hist + jnp.concatenate([hist[:, 1:], zero], axis=1)
        sm_d = dsum + jnp.concatenate([dsum[:, 1:], zero], axis=1)
        cnt, bidx = jax.lax.top_k(sm_h, top_t)                # (S, T)
        d = jnp.take_along_axis(sm_d, bidx, axis=1)
        diag_est = jnp.where(cnt > 0,
                             d // jnp.maximum(cnt, 1) - NQ, 0)
        return cnt, diag_est

    cnt, diag = jax.vmap(per_block)(sorted_codes, sorted_pos)
    # (NB_l, S, T) -> (S, NB_l, T)
    return cnt.transpose(1, 0, 2), diag.transpose(1, 0, 2)


def _select_read_candidates(cnt, tid, gdiag, *, K, min_hits,
                            alpha, beta, bin_w, prune=0.0):
    """Global per-read candidate selection over the gathered table.

    cnt/tid/gdiag: (N,) flattened (strand, block, T) candidates for ONE
    read, fwd-strand first then block-ascending (strand is folded into
    ``tid`` by sign so dedup never merges across strands).
    Returns (sel (K,) bool, idx (K,) int32 into the flat arrays,
    score (K,) float32).
    """
    N = cnt.shape[0]
    valid = cnt >= min_hits
    # stable cnt-descending order (ties keep enumeration order, matching
    # the host's stable sort in _finalize_read_candidates)
    order = jnp.argsort(-cnt, stable=True)
    s_cnt = cnt[order]
    s_tid = tid[order]
    s_gd = gdiag[order]
    s_valid = valid[order]

    def body(kept, i):
        near = kept & (s_tid == s_tid[i]) \
            & (jnp.abs(s_gd - s_gd[i]) <= bin_w)
        keep = s_valid[i] & ~jnp.any(near)
        return kept.at[i].set(keep), None

    kept, _ = jax.lax.scan(body, jnp.zeros(N, bool), jnp.arange(N))
    n_kept = jnp.maximum(jnp.sum(kept.astype(jnp.int32)), 1)
    mean = jnp.sum(jnp.where(kept, s_cnt, 0).astype(jnp.float32)) \
        / n_kept.astype(jnp.float32)
    score = jnp.clip(s_cnt.astype(jnp.float32),
                     jnp.float32(alpha) * mean, jnp.float32(beta) * mean)
    if prune > 0.0:
        # pre-extension prune on the CLAMPED score — where the
        # alpha/beta clamp acts on outcomes; float32 arithmetic matches
        # the host path bit-for-bit (ops/seedextend.py
        # _finalize_read_candidates)
        best_s = jnp.max(jnp.where(kept, score, 0))
        kept = kept & (score >= jnp.float32(prune) * best_s)
    # the clamp is monotone, so cnt-descending kept order IS
    # score-descending (the host's stable re-sort is a no-op): the global
    # top-K are simply the first K kept entries
    krank = jnp.cumsum(kept.astype(jnp.int32)) - 1
    pick = kept & (krank < K)
    slot = jnp.where(pick, krank, K)
    idx_out = jnp.zeros(K + 1, jnp.int32).at[slot].set(
        order.astype(jnp.int32))[:K]
    sel_out = jnp.zeros(K + 1, bool).at[slot].set(pick)[:K]
    score_out = jnp.zeros(K + 1, jnp.float32).at[slot].set(score)[:K]
    return sel_out, idx_out, score_out


def _seed_body(q_fwd, q_rev, read_lens, block_lens, block_seq, block_start,
               sorted_codes, sorted_pos, *, k, BL, bin_w, min_hits, occ,
               max_occ, alpha, beta, K, prune, block_axis):
    """SEED per-shard body: local seeding + all_gather + global top-K."""
    B, NQ = q_fwd.shape
    nbins = int(np.ceil((BL + NQ) / bin_w)) + 2

    qk_f, qv_f = kmer_codes_batch(q_fwd, read_lens, k)
    qk_r, qv_r = kmer_codes_batch(q_rev, read_lens, k)

    seed = functools.partial(_seed_block_candidates, NQ=NQ, nbins=nbins,
                             bin_w=bin_w, occ=occ, max_occ=max_occ,
                             top_t=K)
    cnt_f, diag_f = seed(qk_f, qv_f, sorted_codes, sorted_pos)
    cnt_r, diag_r = seed(qk_r, qv_r, sorted_codes, sorted_pos)
    cnt = jnp.stack([cnt_f, cnt_r], axis=1)    # (B, 2, NB_l, T)
    diag = jnp.stack([diag_f, diag_r], axis=1)

    # gather the candidate tables + block metadata over the block axis
    cnt = jax.lax.all_gather(cnt, block_axis, axis=2, tiled=True)
    diag = jax.lax.all_gather(diag, block_axis, axis=2, tiled=True)
    g_seq = jax.lax.all_gather(block_seq, block_axis, axis=0, tiled=True)
    g_start = jax.lax.all_gather(block_start, block_axis, axis=0,
                                 tiled=True)

    NBg = g_seq.shape[0]
    N = 2 * NBg * K
    # flat per-candidate metadata, fwd-strand first then rev (the host
    # enumerates fwd/rev streams in that order)
    strand_f = jnp.repeat(jnp.array([1, 0], jnp.int32), NBg * K)   # (N,)
    block_f = jnp.tile(jnp.repeat(jnp.arange(NBg, dtype=jnp.int32), K), 2)
    cnt2 = cnt.reshape(B, N)
    diag2 = diag.reshape(B, N)
    tid_f = (g_seq[block_f] + 1) * jnp.where(strand_f == 1, 1, -1)
    gdiag2 = g_start[block_f][None, :] + diag2

    sel, idx, score = jax.vmap(
        functools.partial(_select_read_candidates, K=K, min_hits=min_hits,
                          alpha=alpha, beta=beta, bin_w=bin_w, prune=prune)
    )(cnt2, jnp.broadcast_to(tid_f, (B, N)), gdiag2)

    c_block = block_f[idx]                    # (B, K) global block id
    c_strand = strand_f[idx] == 1
    c_diag = jnp.take_along_axis(diag2, idx, axis=1)
    c_cnt = jnp.take_along_axis(cnt2, idx, axis=1)
    return sel, c_block, c_strand, c_diag, c_cnt, score


def make_sharded_seeder(mesh, *, k, BL, bin_w, min_hits, occ=4,
                        max_occ=256, alpha=0.5, beta=2.0, K=8, prune=0.0,
                        data_axis="data", block_axis="block"):
    """jit(shard_map(seed step)): reads data-parallel, index
    block-sharded, per-read candidate tables data-sharded."""
    body = functools.partial(
        _seed_body, k=k, BL=BL, bin_w=bin_w, min_hits=min_hits, occ=occ,
        max_occ=max_occ, alpha=alpha, beta=beta, K=K, prune=prune,
        block_axis=block_axis)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(data_axis, None), P(data_axis, None), P(data_axis),
                  P(block_axis), P(block_axis), P(block_axis),
                  P(block_axis, None), P(block_axis, None)),
        out_specs=(P(data_axis, None),) * 6,
        check_vma=False)
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# EXTEND step (device)


def _extend_body(q, qlen, t, tlen, c0, *, W, match, mismatch, gap, x_drop,
                 max_steps):
    res = banded_align(q, qlen, t, tlen, c0, W=W, match=match,
                       mismatch=mismatch, gap=gap, x_drop=x_drop)
    moves, nmoves, si, sj = traceback(res.dirs, res.centers, res.best_i,
                                      res.best_j, max_steps=max_steps)
    # start column -> window coordinate (needs the per-row band centers,
    # which never leave the device): tb = si + centers[si] - W/2 + sj
    cen_si = jnp.take_along_axis(res.centers, si[:, None],
                                 axis=1).squeeze(1)
    tb = si + cen_si - W // 2 + sj
    return res.score, moves, si, tb


def make_sharded_extender(mesh, *, W, match=2, mismatch=-4, gap=-3,
                          x_drop=0, max_steps, data_axis="data",
                          block_axis="block"):
    """jit(shard_map(extend step)) with lanes sharded over ALL devices
    (the lane dim is pure data parallelism — both mesh axes serve it)."""
    lanes = (data_axis, block_axis)
    body = functools.partial(_extend_body, W=W, match=match,
                             mismatch=mismatch, gap=gap, x_drop=x_drop,
                             max_steps=max_steps)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(lanes, None), P(lanes), P(lanes, None), P(lanes),
                  P(lanes)),
        out_specs=(P(lanes), P(lanes, None), P(lanes), P(lanes)),
        check_vma=False)
    return jax.jit(fn)


def put_sharded_index(index: BlockIndex, mesh, block_axis="block"):
    """Device-put the block index with block-axis sharding."""
    bspec = NamedSharding(mesh, P(block_axis))
    bspec2 = NamedSharding(mesh, P(block_axis, None))
    return (jax.device_put(index.block_lens, bspec),
            jax.device_put(index.block_seq, bspec),
            jax.device_put(index.block_start, bspec),
            jax.device_put(index.sorted_codes, bspec2),
            jax.device_put(index.sorted_pos, bspec2))
