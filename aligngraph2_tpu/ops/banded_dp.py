"""Adaptive banded local-alignment DP kernel with device traceback.

This is the compute core of the seed-extend aligner that replaces the
reference's external ``mecat2ref``/``mecat2ref+``/``nucmer`` binaries
(SURVEY.md §2.5 C1-C3; the mecat sources are absent submodules, so the
kernel is built from the observable contract: local alignments of noisy
long reads against a target, reported as scored gapped alignments).

Design (plain JAX; the adaptive-band path for reads past the static
buckets and for the multi-device mesh, parallel/sharded.py):
  * The DP matrix is never materialized.  A ``lax.scan`` walks query rows;
    each step holds one band of W cells (W = 128..512), so all row math
    is dense (W,)-vector work.
  * The band is *adaptive*: its center diagonal drifts by at most +-1 per
    row toward the current row argmax, letting the band follow indel drift
    far beyond W/2 without widening.
  * Within-row gap chains (query gaps) are resolved with a Kogge-Stone
    max-plus scan: log2(W) shift+max steps instead of a serial pass.
  * Direction codes (one byte per cell) and per-row band centers stay in
    device memory; a second batched ``lax.scan`` walks the traceback
    entirely on device, so hosts only receive compact move strings.

Scoring: Smith-Waterman local with linear gaps (match/mismatch/gap from
AlignerConfig).  Scores are int32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(1 << 28))

# direction codes
STOP, DIAG, UP, LEFT = 0, 1, 2, 3

# lanes of one batch on a GPU: the per-row while loop costs about the
# same at any width, so a batch is as wide as memory allows up to this
SCAN_MAX_LANES = 512


def scan_lanes(NQ: int, NT: int, W: int, device=None) -> int:
    """Lanes of one banded_align + traceback batch.  On the CPU, 64 MB
    of direction bytes (at most 64 lanes); on a GPU, one batch in a
    sixteenth of the memory the device reports, and an error on a
    device that reports none or is too small for one lane."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return max(1, min(64, (64 << 20) // (NQ * W)))
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"{device} reports no memory limit")
    # dirs, centers, moves, query, window
    per_lane = NQ * W + 4 * (NQ + 1) + (NQ + NT) + NQ + NT
    n = min(SCAN_MAX_LANES, stats["bytes_limit"] // 16 // per_lane)
    if n < 1:
        raise RuntimeError(f"one lane at NQ={NQ}, W={W} does not fit in "
                           f"{stats['bytes_limit']} bytes")
    return n


class BandedResult(NamedTuple):
    score: jax.Array      # (B,) int32 best local score
    best_i: jax.Array     # (B,) int32 query end row (exclusive)
    best_j: jax.Array     # (B,) int32 band column of the end cell
    dirs: jax.Array       # (B, NQ, W) uint8 direction codes per cell
    centers: jax.Array    # (B, NQ+1) int32 band center diagonal per row


def _row_kernel(carry, xs, *, W, match, mismatch, gap, ks_shifts):
    """One DP row: carry = (H_prev, c_prev, best, b_i, b_j, t_pad, qlen,
    tlen); xs = (q_base, i)."""
    H_prev, c_prev, best, b_i, b_j, t_pad, qlen, tlen = carry
    q_base, i = xs

    # adaptive drift: move the band center toward the running argmax
    row_max = jnp.max(H_prev)
    drift = jnp.argmax(H_prev).astype(jnp.int32) - W // 2
    dc = jnp.where(row_max > 0, jnp.clip(drift, -1, 1), 0)
    c = jnp.clip(c_prev + dc, -W, t_pad.shape[0])

    # predecessors from the previous row, shifted for the drift:
    #   diag pred of (i, j) lives at H_prev[j + dc], up pred at [j + dc + 1]
    padded = jnp.concatenate([NEG * jnp.ones(1, jnp.int32), H_prev,
                              NEG * jnp.ones(2, jnp.int32)])
    diag_vals = jax.lax.dynamic_slice(padded, (dc + 1,), (W,))
    up_vals = jax.lax.dynamic_slice(padded, (dc + 2,), (W,))

    # target bases under the band: cell (i, j) consumes t[p-1] on a diag
    # move, p = i + c - W/2 + j.  t_pad has PADL = W + 2 sentinel bases.
    start = (i - 1) + c - W // 2 + (W + 2)
    t_slice = jax.lax.dynamic_slice(t_pad, (start,), (W,)).astype(jnp.int32)
    sub = jnp.where(t_slice == q_base, match, mismatch)

    d_v = diag_vals + sub
    u_v = up_vals + gap
    M = jnp.maximum(d_v, u_v)
    m_dir = jnp.where(d_v >= u_v, DIAG, UP).astype(jnp.uint8)
    m_dir = jnp.where(M > 0, m_dir, STOP)
    M = jnp.maximum(M, 0)

    # query-gap chain along the row: Kogge-Stone max-plus prefix scan
    H = M
    for sh in ks_shifts:
        shifted = jnp.concatenate([NEG * jnp.ones(sh, jnp.int32), H[:-sh]])
        H = jnp.maximum(H, shifted + gap * sh)
    dirs = jnp.where(H > M, jnp.uint8(LEFT), m_dir)

    # validity: p in [0, tlen], row i <= qlen
    j_idx = jax.lax.broadcasted_iota(jnp.int32, (W, 1), 0).squeeze(-1)
    p = i + c - W // 2 + j_idx
    ok = (p >= 0) & (p <= tlen) & (i <= qlen)
    H = jnp.where(ok, H, NEG)
    dirs = jnp.where(ok, dirs, jnp.uint8(STOP))

    # best-cell tracking
    r_max = jnp.max(H)
    r_arg = jnp.argmax(H).astype(jnp.int32)
    upd = r_max > best
    best = jnp.where(upd, r_max, best)
    b_i = jnp.where(upd, i, b_i)
    b_j = jnp.where(upd, r_arg, b_j)

    return (H, c, best, b_i, b_j, t_pad, qlen, tlen), (dirs, c)


@functools.partial(jax.jit,
                   static_argnames=("W", "match", "mismatch", "gap",
                                    "x_drop"))
def banded_align(q, qlen, t, tlen, c0, *, W=256, match=2, mismatch=-4,
                 gap=-3, x_drop=0) -> BandedResult:
    """Batched adaptive banded local alignment.

    q: (B, NQ) uint8 query codes (aligned strand), qlen: (B,)
    t: (B, NT) uint8 target window codes,           tlen: (B,)
    c0: (B,) int32 initial band center diagonal (t_pos - q_pos estimate,
        relative to the window start)
    x_drop: > 0 enables early termination (the mecat-class extension
        contract): a lane dies once its row frontier drops more than
        x_drop below its best-so-far (after it has started scoring) or
        its rows run past qlen; the whole batch stops when every lane is
        dead.  0 = fixed NQ rows (bit-identical to the x_drop path for
        lanes whose frontier never drops by x_drop).
    """
    B, NQ = q.shape
    ks_shifts = tuple(1 << s for s in range(int(np.log2(W))))
    if x_drop > 0:
        return _banded_align_xdrop(q, qlen, t, tlen, c0, W=W, match=match,
                                   mismatch=mismatch, gap=gap,
                                   x_drop=x_drop, ks_shifts=ks_shifts)

    def one(qb, qlenb, tb, tlenb, c0b):
        # initial row 0: score 0 at valid p, NEG elsewhere
        j_idx = jax.lax.broadcasted_iota(jnp.int32, (W, 1), 0).squeeze(-1)
        p0 = c0b - W // 2 + j_idx
        H0 = jnp.where((p0 >= 0) & (p0 <= tlenb), 0, NEG).astype(jnp.int32)
        t_pad = jnp.concatenate([
            jnp.full(W + 2, 255, jnp.uint8), tb,
            jnp.full(W + NQ + 2, 255, jnp.uint8)])
        carry = (H0, c0b.astype(jnp.int32), jnp.int32(0), jnp.int32(0),
                 jnp.int32(0), t_pad, qlenb.astype(jnp.int32),
                 tlenb.astype(jnp.int32))
        xs = (qb.astype(jnp.int32), jnp.arange(1, NQ + 1, dtype=jnp.int32))
        kernel = functools.partial(_row_kernel, W=W, match=match,
                                   mismatch=mismatch, gap=gap,
                                   ks_shifts=ks_shifts)
        (H, c_last, best, b_i, b_j, *_), (dirs, centers) = jax.lax.scan(
            kernel, carry, xs)
        centers = jnp.concatenate([c0b[None].astype(jnp.int32), centers])
        return best, b_i, b_j, dirs, centers

    score, bi, bj, dirs, centers = jax.vmap(one)(q, qlen, t, tlen, c0)
    return BandedResult(score, bi, bj, dirs, centers)


def _banded_align_xdrop(q, qlen, t, tlen, c0, *, W, match, mismatch, gap,
                        x_drop, ks_shifts):
    """x-drop variant: a batched while_loop over rows (no per-lane vmap,
    so one all-lanes-dead test stops the whole batch early).  Row math is
    the batched transcription of _row_kernel; dead lanes stop updating
    state, so surviving lanes' results equal the x_drop=0 path."""
    B, NQ = q.shape
    NT = t.shape[1]
    PADL = W + 2
    t_pad = jnp.concatenate([
        jnp.full((B, PADL), 255, jnp.uint8), t,
        jnp.full((B, W + NQ + 2), 255, jnp.uint8)], axis=1)
    j_idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    c0 = c0.astype(jnp.int32)
    p0 = c0[:, None] - W // 2 + j_idx
    H0 = jnp.where((p0 >= 0) & (p0 <= tlen[:, None]), 0, NEG
                   ).astype(jnp.int32)
    q32 = q.astype(jnp.int32)
    centers0 = jnp.zeros((B, NQ + 1), jnp.int32)
    centers0 = centers0.at[:, 0].set(c0)

    def cond(carry):
        i, H, c, best, b_i, b_j, dirs, centers, alive = carry
        return (i <= NQ) & jnp.any(alive)

    def body(carry):
        i, H, c, best, b_i, b_j, dirs, centers, alive = carry
        row_max = jnp.max(H, axis=1)
        drift = jnp.argmax(H, axis=1).astype(jnp.int32) - W // 2
        dc = jnp.where(row_max > 0, jnp.clip(drift, -1, 1), 0)
        c_new = jnp.clip(c + dc, -W, NT)
        padded = jnp.concatenate([
            jnp.full((B, 1), NEG, jnp.int32), H,
            jnp.full((B, 2), NEG, jnp.int32)], axis=1)
        diag_vals = jnp.take_along_axis(padded, dc[:, None] + 1 + j_idx,
                                        axis=1)
        up_vals = jnp.take_along_axis(padded, dc[:, None] + 2 + j_idx,
                                      axis=1)
        start = (i - 1) + c_new + (PADL - W // 2)
        t_slice = jnp.take_along_axis(
            t_pad, start[:, None] + j_idx, axis=1).astype(jnp.int32)
        q_base = jnp.take_along_axis(q32, jnp.full((B, 1), i - 1,
                                                   jnp.int32), axis=1)
        sub = jnp.where(t_slice == q_base, match, mismatch)
        d_v = diag_vals + sub
        u_v = up_vals + gap
        M = jnp.maximum(d_v, u_v)
        m_dir = jnp.where(d_v >= u_v, DIAG, UP).astype(jnp.uint8)
        m_dir = jnp.where(M > 0, m_dir, jnp.uint8(STOP))
        M = jnp.maximum(M, 0)
        Hn = M
        for sh in ks_shifts:
            shifted = jnp.concatenate([
                jnp.full((B, sh), NEG, jnp.int32), Hn[:, :-sh]], axis=1)
            Hn = jnp.maximum(Hn, shifted + gap * sh)
        row_dirs = jnp.where(Hn > M, jnp.uint8(LEFT), m_dir)
        p = i + c_new[:, None] - W // 2 + j_idx
        ok = (p >= 0) & (p <= tlen[:, None]) & (i <= qlen[:, None])
        Hn = jnp.where(ok, Hn, NEG)
        row_dirs = jnp.where(ok, row_dirs, jnp.uint8(STOP))
        # dead lanes freeze: state unchanged, dirs stay STOP
        Hn = jnp.where(alive[:, None], Hn, H)
        c_new = jnp.where(alive, c_new, c)
        row_dirs = jnp.where(alive[:, None], row_dirs, jnp.uint8(STOP))
        r_max = jnp.max(Hn, axis=1)
        r_arg = jnp.argmax(Hn, axis=1).astype(jnp.int32)
        upd = alive & (r_max > best)
        best = jnp.where(upd, r_max, best)
        b_i = jnp.where(upd, i, b_i)
        b_j = jnp.where(upd, r_arg, b_j)
        dirs = jax.lax.dynamic_update_slice(
            dirs, row_dirs[:, None, :], (0, i - 1, 0))
        centers = jax.lax.dynamic_update_slice(
            centers, c_new[:, None], (0, i))
        alive = alive & (i < qlen) \
            & ((best == 0) | (r_max >= best - x_drop))
        return i + 1, Hn, c_new, best, b_i, b_j, dirs, centers, alive

    dirs0 = jnp.zeros((B, NQ, W), jnp.uint8)
    carry = (jnp.int32(1), H0, c0, jnp.zeros(B, jnp.int32),
             jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), dirs0,
             centers0, jnp.ones(B, bool))
    _, _, _, best, b_i, b_j, dirs, centers, _ = jax.lax.while_loop(
        cond, body, carry)
    return BandedResult(best, b_i, b_j, dirs, centers)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback(dirs, centers, best_i, best_j, *, max_steps):
    """Batched device traceback.

    Returns (moves (B, max_steps) uint8 in END->START order, n_moves (B,),
    start_i (B,), start_j (B,)).  Move codes are DIAG/UP/LEFT; 0 entries
    past n_moves are padding.
    """
    B, NQ, W = dirs.shape

    def one(d, cen, bi, bj):
        def step(carry, _):
            i, j, active = carry
            cur = d[jnp.maximum(i - 1, 0), j]
            cur = jnp.where(active & (i > 0), cur, STOP)
            dc = cen[i] - cen[jnp.maximum(i - 1, 0)]
            ni = jnp.where(cur == LEFT, i, i - 1)
            nj = jnp.where(cur == LEFT, j - 1,
                           jnp.where(cur == DIAG, j + dc, j + dc + 1))
            emit = jnp.where(cur == STOP, 0, cur).astype(jnp.uint8)
            live = active & (cur != STOP)
            i = jnp.where(live, ni, i)
            j = jnp.where(live, nj, j)
            return (i, j, live), emit

        (si, sj, _), moves = jax.lax.scan(
            step, (bi, bj, jnp.bool_(True)), None, length=max_steps)
        n = jnp.sum((moves != 0).astype(jnp.int32))
        return moves, n, si, sj

    return jax.vmap(one)(dirs, centers, best_i, best_j)


# ---------------------------------------------------------------------------
# host-side helpers


def numpy_local_align(q: np.ndarray, t: np.ndarray, match=2, mismatch=-4,
                      gap=-3):
    """Unbanded Smith-Waterman oracle for tests (O(nm), host)."""
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        sub = np.where(t == q[i - 1], match, mismatch)
        for p in range(1, m + 1):
            v = max(H[i - 1][p - 1] + sub[p - 1], H[i - 1][p] + gap,
                    H[i][p - 1] + gap, 0)
            H[i][p] = v
            if v > best:
                best, bi, bj = v, i, p
    return int(best), bi, bj


def moves_to_strings(moves_rev: np.ndarray, q_codes: np.ndarray,
                     start_q: int, start_t: int, t_codes: np.ndarray):
    """Reconstruct gapped strings from END->START move codes.

    Returns (qstr, tstr, qe, te) — gapped ASCII strings plus end-exclusive
    coordinates; start_q/start_t are the begin coordinates from traceback.
    """
    from ..io.seqdb import decode_seq
    moves = moves_rev[moves_rev != 0][::-1]
    q_adv = (moves != LEFT)
    t_adv = (moves != UP)
    qi = start_q + np.cumsum(q_adv) - q_adv
    ti = start_t + np.cumsum(t_adv) - t_adv
    qs = np.where(q_adv, q_codes[np.minimum(qi, len(q_codes) - 1)], 4)
    ts = np.where(t_adv, t_codes[np.minimum(ti, len(t_codes) - 1)], 4)
    table = np.frombuffer(b"ACGT-", dtype=np.uint8)
    qstr = table[qs].tobytes().decode()
    tstr = table[ts].tobytes().decode()
    qe = int(start_q + q_adv.sum())
    te = int(start_t + t_adv.sum())
    return qstr, tstr, qe, te
