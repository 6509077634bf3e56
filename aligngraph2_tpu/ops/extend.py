"""Static-band seed extension: the hot path of every aligner stage.

Each lane aligns one query against a target window built so that the
seed diagonal sits at band centre (the "standard frame"):

  * cell (i, j), query row i in 1..NQ and band column j in 0..W-1, reads
    t[i-1+j]; row 0 is all zeros (local alignment);
  * queries pad with Q_SENTINEL and windows with T_SENTINEL, which never
    match anything, so cells outside the real sequences cannot rise
    above the local floor of 0 and need no validity masks;
  * linear gaps: the query-gap chain along a row is a max-plus prefix
    scan, H_j = gap*j + max_{k<=j} (M_k - gap*k);
  * direction codes (STOP/DIAG/UP/LEFT, ties as in ops/banded_dp.py)
    leave the extension packed: bits (2s, 2s+1) of words[b, w, j] hold
    row 16*w + s + 1, column j;
  * the best cell is the first row reaching the maximum, then its
    smallest column;
  * a lane stops after row i once i >= qlen, or, with x_drop > 0 and a
    positive best, once the row's maximum falls more than x_drop below
    the best (the rule of ops/banded_dp.py).  Its later words are not
    defined; the traceback starts at best_i and never reads them.

Two implementations compute this bit for bit: ``extend_cuda``, the
Hopper kernel of native/extend.cu called through the XLA FFI, and
``extend_reference``, the plain lax.scan specification.
``extension_impl`` is the one place that picks between them.  The
traceback walk, the host fetch and the run-length expansion below are
shared by both.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .banded_dp import STOP, DIAG, UP, LEFT

NEG = -(1 << 28)
Q_SENTINEL = 254
T_SENTINEL = 255

# lanes of one batch on the CPU, where only the tests and small runs go
CPU_LANES = 16
# lanes of one batch on the GPU: enough warps to fill every SM several
# times over, few enough that two batches in flight overlap host work
MAX_LANES = 4096

# extension batches run since import, by implementation
BATCHES = {"kernel": 0, "reference": 0}


class ExtendResult(NamedTuple):
    score: jax.Array    # (B,) int32
    best_i: jax.Array   # (B,) int32
    best_j: jax.Array   # (B,) int32
    words: jax.Array    # (B, NQ//16, W) int32 packed direction codes


@functools.partial(jax.jit, static_argnames=("W", "match", "mismatch",
                                             "gap", "x_drop"))
def extend_reference(q, t, qlen, *, W, match, mismatch, gap, x_drop):
    """q: (B, NQ) uint8 padded with Q_SENTINEL; t: (B, NQ + W) uint8
    windows padded with T_SENTINEL; qlen: (B,) query lengths.  NQ % 16
    == 0.  Returns ExtendResult; dead lanes write STOP words."""
    B, NQ = q.shape
    j = jnp.arange(W, dtype=jnp.int32)
    q32 = q.astype(jnp.int32)
    t32 = t.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)

    def row(carry, i):
        H, best, bi, bj, alive = carry
        qc = jax.lax.dynamic_slice_in_dim(q32, i - 1, 1, axis=1)
        tw = jax.lax.dynamic_slice_in_dim(t32, i - 1, W, axis=1)
        up = jnp.concatenate([H[:, 1:], jnp.full((B, 1), NEG, jnp.int32)],
                             axis=1)
        dv = H + jnp.where(tw == qc, match, mismatch)
        uv = up + gap
        m = jnp.maximum(dv, uv)
        code = jnp.where(m > 0, jnp.where(dv >= uv, DIAG, UP), STOP)
        M = jnp.maximum(m, 0)
        Hn = gap * j + jax.lax.cummax(M - gap * j, axis=1)
        code = jnp.where(Hn > M, LEFT, code)
        rmax = Hn.max(axis=1)
        upd = alive & (rmax > best)
        best = jnp.where(upd, rmax, best)
        bi = jnp.where(upd, i, bi)
        bj = jnp.where(upd, jnp.argmax(Hn, axis=1).astype(jnp.int32), bj)
        H = jnp.where(alive[:, None], Hn, H)
        code = jnp.where(alive[:, None], code, STOP)
        nxt = i < qlen
        if x_drop > 0:
            nxt = nxt & ((best == 0) | (rmax >= best - x_drop))
        return (H, best, bi, bj, alive & nxt), code

    def block(carry, w):
        word = jnp.zeros((B, W), jnp.int32)
        for s in range(16):
            carry, code = row(carry, 16 * w + s + 1)
            word = word | (code << (2 * s))
        return carry, word

    zeros = jnp.zeros(B, jnp.int32)
    carry = (jnp.zeros((B, W), jnp.int32), zeros, zeros, zeros,
             jnp.ones(B, bool))
    (_, best, bi, bj, _), words = jax.lax.scan(
        block, carry, jnp.arange(NQ // 16, dtype=jnp.int32))
    return ExtendResult(best, bi, bj, jnp.moveaxis(words, 0, 1))


# ---------------- the Hopper kernel ----------------

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_CU_SRC = os.path.join(_NATIVE_DIR, "extend.cu")
_CU_SO = os.path.join(_NATIVE_DIR, "libextend.so")
_FFI_TARGET = "agx_extend"
_kernel_lock = threading.Lock()
_kernel_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def load_extension_kernel() -> None:
    """Build native/extend.cu for sm_90a on first use (next to its
    source, beside the host cores) and register it as an FFI target.
    Raises on any build or load failure: the GPU has no other path."""
    global _kernel_lib
    from ..utils.nativebuild import build_lib
    with _kernel_lock:
        if _kernel_lib is not None:
            return
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-I", jax.ffi.include_dir()]
        build_lib(_CU_SRC, _CU_SO, flags, compiler=nvcc_path(),
                  timeout=600.0)
        lib = ctypes.cdll.LoadLibrary(_CU_SO)
        jax.ffi.register_ffi_target(
            _FFI_TARGET, jax.ffi.pycapsule(lib.AgxExtend), platform="CUDA")
        _kernel_lib = lib


@functools.partial(jax.jit, static_argnames=("W", "match", "mismatch",
                                             "gap", "x_drop"))
def extend_cuda(q, t, qlen, *, W, match, mismatch, gap, x_drop):
    """The kernel of native/extend.cu; same contract as
    extend_reference.  Call load_extension_kernel() first."""
    B, NQ = q.shape
    out = [jax.ShapeDtypeStruct((B,), jnp.int32)] * 3 + [
        jax.ShapeDtypeStruct((B, NQ // 16, W), jnp.int32)]
    score, bi, bj, words = jax.ffi.ffi_call(_FFI_TARGET, out)(
        q, t, qlen.astype(jnp.int32), match=np.int32(match),
        mismatch=np.int32(mismatch), gap=np.int32(gap),
        x_drop=np.int32(x_drop))
    return ExtendResult(score, bi, bj, words)


# ---------------- choice by platform ----------------

def extension_impl(platform: str | None = None):
    """(name, function) of the extension for ``platform`` (default: the
    default backend's).  The GPU runs the kernel; the CPU, which has no
    kernel, runs the reference; any other platform is an error."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        load_extension_kernel()
        return "kernel", extend_cuda
    if platform == "cpu":
        return "reference", extend_reference
    raise RuntimeError(f"no seed extension for platform {platform!r}")


def extend(q, t, qlen, *, W, match, mismatch, gap, x_drop) -> ExtendResult:
    name, fn = extension_impl()
    BATCHES[name] += 1
    return fn(q, t, qlen, W=W, match=match, mismatch=mismatch, gap=gap,
              x_drop=x_drop)


def lane_bytes(NQ: int, W: int) -> int:
    """Device bytes one lane holds while its batch is in flight: query,
    window, packed words, and the traceback's two run buffers."""
    return NQ + (NQ + W) + NQ * W // 4 + 2 * (2 * NQ + W + 1)


def max_lanes(NQ: int, W: int, device=None) -> int:
    """Lanes per extension batch.  On the GPU, two batches in flight
    (the aligner's software pipeline) take at most a quarter of the
    memory the device reports; a device that reports none is an
    error."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return CPU_LANES
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"{device} reports no memory limit")
    n = min(MAX_LANES, stats["bytes_limit"] // 8 // lane_bytes(NQ, W))
    if n < 1:
        raise RuntimeError(f"one lane at NQ={NQ}, W={W} does not fit "
                           f"in {stats['bytes_limit']} bytes")
    return n if n < 32 else n // 32 * 32


def padded_lanes(n_jobs: int, cap: int) -> int:
    """Lanes a batch of n_jobs is padded to: a power of two of at least
    32 (one compile per shape, few shapes per bucket), never above cap."""
    return min(cap, max(32, 1 << max(n_jobs - 1, 0).bit_length()))


# ---------------- traceback ----------------

def unpack_words(words):
    """(B, NQ//16, W) packed words -> (B, NQ, W) uint8 direction codes."""
    B, NW, W = words.shape
    shifts = (jnp.arange(16, dtype=jnp.int32) * 2)[None, None, :, None]
    d = (words[:, :, None, :] >> shifts) & 3
    return d.astype(jnp.uint8).reshape(B, NW * 16, W)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback_t(words, best_i, best_j, *, max_steps):
    """Reference device traceback: one gather per move over the packed
    words, constant standard-frame band (diag pred keeps j, up pred j+1,
    left pred j-1).  The production path is traceback_fast (run-length
    walk); this one is the simple oracle it is tested against.

    Returns (moves (B, max_steps) uint8 END->START, n_moves, start_i,
    start_j); the alignment's target start is start_i + start_j."""
    B, NW, W = words.shape
    barange = jnp.arange(B, dtype=jnp.int32)

    def cond(carry):
        step_no, i, j, active, moves = carry
        return (step_no < max_steps) & jnp.any(active)

    def body(carry):
        step_no, i, j, active, moves = carry      # i/j/active: (B,)
        ii = jnp.maximum(i - 1, 0)
        word = words[barange, jnp.clip(ii >> 4, 0, NW - 1),
                     jnp.clip(j, 0, W - 1)]
        cur = ((word >> (2 * (ii & 15))) & 3).astype(jnp.uint8)
        cur = jnp.where(active & (i > 0), cur, STOP)
        ni = jnp.where(cur == LEFT, i, i - 1)
        nj = jnp.where(cur == LEFT, j - 1,
                       jnp.where(cur == DIAG, j, j + 1))
        emit = jnp.where(cur == STOP, 0, cur).astype(jnp.uint8)
        moves = jax.lax.dynamic_update_slice(
            moves, emit[:, None], (0, step_no))
        live = active & (cur != STOP)
        i = jnp.where(live, ni, i)
        j = jnp.where(live, nj, j)
        return step_no + 1, i, j, live, moves

    moves0 = jnp.zeros((B, max_steps), jnp.uint8)
    _, si, sj, _, moves = jax.lax.while_loop(
        cond, body, (jnp.int32(0), best_i, best_j,
                     jnp.ones_like(best_i, dtype=bool), moves0))
    n = jnp.sum((moves != 0).astype(jnp.int32), axis=1)
    return moves, n, si, sj


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback_packed_device(words, best_i, best_j, *, max_steps):
    """Device half of the fast traceback (see :func:`traceback_fast`).

    DIAG moves keep the band column j constant, and each packed word
    holds 16 consecutive rows of one column, so a single gather serves
    a whole DIAG run: each iteration consumes the run plus its
    terminating UP/LEFT with unrolled bit operations, cutting iterations
    by about the mean DIAG run length.  Emits per-iteration run-length
    codes (runs[b,it] DIAGs then moves[b,it] if nonzero); the host
    expander reconstructs the exact traceback_t output.
    """
    B, NW, W = words.shape
    barange = jnp.arange(B, dtype=jnp.int32)
    MI = max_steps + 1

    def cond(c):
        it, i, j, n, active, runs, mvs = c
        return jnp.any(active) & (it < MI)

    def body(c):
        it, i, j, n, active, runs, mvs = c     # i/j/n: (B,) int32
        ii = i - 1
        live = active & (i > 0)
        word = words[barange, jnp.clip(ii >> 4, 0, NW - 1),
                     jnp.clip(j, 0, W - 1)]
        bit = ii & 15                          # slot of the current row
        run = jnp.zeros(B, jnp.int32)
        mv = jnp.zeros(B, jnp.int32)
        stopped = jnp.zeros(B, bool)
        consuming = live
        for s in range(16):
            avail = consuming & (bit >= s)
            cur = (word >> (2 * jnp.maximum(bit - s, 0))) & 3
            isdiag = avail & (cur == DIAG)
            hit_term = avail & (cur != DIAG)
            run = run + isdiag.astype(jnp.int32)
            stopped = stopped | (hit_term & (cur == STOP))
            mv = jnp.where(hit_term & (cur != STOP), cur, mv)
            consuming = isdiag
        is_up = (mv == UP).astype(jnp.int32)
        is_left = (mv == LEFT).astype(jnp.int32)
        i = jnp.where(live, i - run - is_up, i)
        j = jnp.where(live, j + is_up - is_left, j)
        n = n + jnp.where(live, run + (mv != 0).astype(jnp.int32), 0)
        runs = jax.lax.dynamic_update_index_in_dim(
            runs, jnp.where(live, run, 0).astype(jnp.uint8), it, 1)
        mvs = jax.lax.dynamic_update_index_in_dim(
            mvs, jnp.where(live, mv, 0).astype(jnp.uint8), it, 1)
        active = active & ~stopped & (i > 0) & (n < max_steps)
        return it + 1, i, j, n, active, runs, mvs

    runs0 = jnp.zeros((B, MI), jnp.uint8)
    mvs0 = jnp.zeros((B, MI), jnp.uint8)
    it, i, j, n, _, runs, mvs = jax.lax.while_loop(
        cond, body, (jnp.int32(0), best_i, best_j,
                     jnp.zeros(B, jnp.int32),
                     jnp.ones(B, bool), runs0, mvs0))
    return runs, mvs, it


def expand_packed_moves(runs, mvs, it_count, best_i, best_j, max_steps):
    """Host half: expand the per-iteration (diag-run, terminator) codes
    into the exact (moves, n, start_i, start_j) of :func:`traceback_t`,
    including its truncation-at-max_steps semantics."""
    B = runs.shape[0]
    C = int(it_count)
    runs = runs[:, :C].astype(np.int64)
    mvs = mvs[:, :C].astype(np.uint8)
    cnt = np.empty((B, 2 * C), np.int64)
    cnt[:, 0::2] = runs
    cnt[:, 1::2] = mvs != 0
    val = np.empty((B, 2 * C), np.uint8)
    val[:, 0::2] = DIAG
    val[:, 1::2] = mvs
    flat = np.repeat(val.ravel(), cnt.ravel())
    tot = cnt.sum(axis=1)
    ends = np.cumsum(tot)
    starts = ends - tot
    n = np.minimum(tot, max_steps)
    cn = np.cumsum(n)
    pos = np.arange(int(cn[-1])) - np.repeat(cn - n, n)
    lane = np.repeat(np.arange(B), n)
    moves = np.zeros((B, max_steps), np.uint8)
    moves[lane, pos] = flat[np.repeat(starts, n) + pos]
    ndiag = (moves == DIAG).sum(axis=1)
    nup = (moves == UP).sum(axis=1)
    nleft = (moves == LEFT).sum(axis=1)
    si = (best_i - ndiag - nup).astype(np.int32)
    sj = (best_j - nleft + nup).astype(np.int32)
    return moves, n.astype(np.int32), si, sj


@jax.jit
def _tb_meta(it, *rows):
    """One (1+len(rows), B) int32 array: the iteration count broadcast
    in row 0, then each extra per-lane row."""
    rows = [r.astype(jnp.int32) for r in rows]
    return jnp.stack([jnp.full_like(rows[0], it)] + rows)


@functools.partial(jax.jit, static_argnames=("Cp",))
def _tb_body(runs, mvs, Cp):
    return jnp.concatenate([runs[:, :Cp], mvs[:, :Cp]], axis=0)


def fetch_packed_traceback(runs, mvs, it, *rows, max_steps):
    """Bring a packed-traceback result to the host in two transfers.

    Only the used prefix of the run-length buffers is copied: the walk
    typically ends after about max_steps / (mean DIAG run) iterations.
    The prefix length is rounded up to a multiple of 256 so the device
    slice compiles a bounded number of shapes.  ``rows`` are extra
    per-lane int32 device arrays (scores, best cells, ...) that ride the
    first transfer.

    Returns (rows_host (len(rows), B) int32, runs_h, mvs_h, C)."""
    meta = np.asarray(_tb_meta(it, *rows))
    C = int(meta[0, 0])
    B = runs.shape[0]
    MI = max_steps + 1
    Cp = min(MI, ((max(C, 1) + 255) // 256) * 256)
    body = np.asarray(_tb_body(runs, mvs, Cp))
    return meta[1:], body[:B], body[B:], min(C, Cp)


def expand_moves(runs_h, mvs_h, it_count, best_i, best_j, max_steps):
    """Run-length -> dense move matrix: native core when available
    (ops/native.py agx_expand), numpy spec otherwise — identical output
    (tests/test_banded_pallas.py)."""
    from .native import expand_moves_native
    res = expand_moves_native(runs_h, mvs_h, it_count, best_i, best_j,
                              max_steps)
    if res is not None:
        return res
    return expand_packed_moves(runs_h, mvs_h, it_count,
                               np.asarray(best_i, np.int32),
                               np.asarray(best_j, np.int32), max_steps)


def traceback_fast(words, best_i, best_j, *, max_steps):
    """Drop-in traceback_t replacement (numpy outputs): packed-word
    device walk + two-transfer host fetch + run-length expansion.
    Exactly equal to traceback_t on all inputs
    (tests/test_banded_pallas.py)."""
    runs, mvs, it = traceback_packed_device(
        words, best_i, best_j, max_steps=max_steps)
    rows, runs_h, mvs_h, C = fetch_packed_traceback(
        runs, mvs, it, best_i, best_j, max_steps=max_steps)
    return expand_moves(runs_h, mvs_h, C, rows[0], rows[1], max_steps)


def standard_frame_windows(t_codes_list, diags, NQ, W):
    """Host helper: build (B, NQ + W) sentinel-padded target windows with
    each candidate's seed diagonal centered (window start = diag - W/2)."""
    B = len(t_codes_list)
    out = np.full((B, NQ + W), T_SENTINEL, np.uint8)
    starts = np.zeros(B, np.int64)
    for b, (codes, diag) in enumerate(zip(t_codes_list, diags)):
        ws = diag - W // 2
        starts[b] = ws
        lo = max(0, ws)
        hi = min(len(codes), ws + NQ + W)
        if hi > lo:
            out[b, lo - ws:hi - ws] = codes[lo:hi]
    return out, starts
