"""Device-side graph merge phases — epsilon position clustering and edge
dedup as XLA sort + segment reductions.

The reference implements these as mutex-guarded per-node vector surgery
(/root/reference/PAGraph/src/tools/graph/PABruijnGraph.cpp:259-297 +
node/KMerAdjNode.tcc:72-111: O(P^2) greedy first-fit clustering per node).
Our semantics are the deterministic chain-clustering specified in
graph/pagraph.py::merge_positions — sort every (node, ctg, ref) triple,
open a new cluster where a position is not epsilon-similar to its sorted
predecessor, sum counts with the uint16 saturation of the reference's
CountType.  That is a multi-key sort + a compare-with-predecessor scan:
exactly the shape XLA tiles well, so the phase runs in one jit on the
accelerator; the host compresses the boundary mask and reduces the
per-cluster count sums (an O(n) cumsum — kept off-device so the sums are
exact without 64-bit device arithmetic, which this codebase leaves
disabled).

All device dtypes are 32-bit native (int32 node ids, uint32 coordinates)
— no packed 64-bit keys, so the kernels are correct with JAX's default
x64-disabled config.

Padding: inputs are padded to power-of-two buckets so recompiles are
O(log N) over a run; pad slots carry sentinel keys that sort after all
real entries and can never merge with them.

Dispatch policy lives in PAGraph.merge_positions/merge_edges: the numpy
path is the specification, the native C++ core and this module are the
production paths (ALIGNGRAPH2_TPU_MERGE=native|device|numpy), with
equality guaranteed by tests/test_merge_device.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _bucket(n: int) -> int:
    cap = 1024
    while cap < n:
        cap <<= 1
    return cap


@jax.jit
def _merge_pos_kernel(node, ctg, ref, cnt, eps):
    """Sort by (node, ctg, ref) and mark cluster boundaries.

    node: int32 (pad sentinel = int32 max), ctg/ref: uint32, cnt: int32.
    Returns sorted (node, ctg, ref, cnt) + boundary mask."""
    snode, sctg, sref, scnt = jax.lax.sort(
        (node, ctg, ref, cnt), num_keys=3, is_stable=True)
    # epsilon similarity vs the sorted predecessor
    # (PABruijnGraph.cpp:266-273: per axis |d| <= eps with both coords
    # nonzero, or both zero); |d| in uint32 via two-sided subtraction
    pc, cc = sctg[:-1], sctg[1:]
    pr, cr = sref[:-1], sref[1:]
    # exact |difference| in uint32 (NOT min of the two wrapped
    # subtractions — that is circular distance and would merge 1 with
    # 2^32-5): pick the true larger operand first
    dc = jnp.where(cc >= pc, cc - pc, pc - cc)
    dr = jnp.where(cr >= pr, cr - pr, pr - cr)
    s1 = (pc != 0) & (cc != 0) & (dc <= eps)
    s2 = (pr != 0) & (cr != 0) & (dr <= eps)
    sim = (s1 | ((pc == 0) & (cc == 0))) & (s2 | ((pr == 0) & (cr == 0)))
    same = sim & (snode[:-1] == snode[1:])
    boundary = jnp.concatenate([jnp.ones(1, bool), ~same])
    return snode, sctg, sref, scnt, boundary


@jax.jit
def _merge_edge_kernel(frm, to, step):
    """Sort (from, to, step) rows and mark first occurrences."""
    sf, st, ss = jax.lax.sort((frm, to, step), num_keys=3, is_stable=True)
    dup = (sf[1:] == sf[:-1]) & (st[1:] == st[:-1]) & (ss[1:] == ss[:-1])
    boundary = jnp.concatenate([jnp.ones(1, bool), ~dup])
    return sf, st, ss, boundary


def merge_positions_device(pos_node: np.ndarray, pos_ctg: np.ndarray,
                           pos_ref: np.ndarray, pos_count: np.ndarray,
                           epsilon: int
                           ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]]:
    """Cluster positions on the accelerator.  Returns (node, ctg, ref,
    count) in the spec's sorted order, or None when a field is out of
    the kernel's 32-bit range (the caller then takes the native core)."""
    n = len(pos_node)
    if n == 0 or int(pos_node.max()) >= np.iinfo(np.int32).max:
        return None
    # The kernel works in uint32; a coordinate above 2^32 would silently
    # truncate and mis-cluster.  Storage is uint32 (pagraph.POS_DTYPES)
    # so this guard only fires for wider test inputs — fall back,
    # mirroring merge_edges_device.
    if int(pos_ctg.max()) > 0xFFFFFFFF or int(pos_ref.max()) > 0xFFFFFFFF:
        return None
    cap = _bucket(n)
    node = np.full(cap, np.iinfo(np.int32).max, np.int32)
    node[:n] = pos_node
    ctg = np.zeros(cap, np.uint32)
    ctg[:n] = pos_ctg.astype(np.uint32)
    ref = np.zeros(cap, np.uint32)
    ref[:n] = pos_ref.astype(np.uint32)
    cnt = np.zeros(cap, np.int32)
    cnt[:n] = np.minimum(pos_count, 0xFFFF).astype(np.int32)
    snode, sctg, sref, scnt, boundary = [
        np.asarray(a)[:n] for a in _merge_pos_kernel(
            jnp.asarray(node), jnp.asarray(ctg), jnp.asarray(ref),
            jnp.asarray(cnt), jnp.uint32(epsilon))]
    firsts = np.flatnonzero(boundary)
    # exact per-cluster count sums via host cumsum (uint16 saturation)
    csum = np.concatenate([[0], np.cumsum(scnt, dtype=np.int64)])
    ends = np.concatenate([firsts[1:], [n]])
    sums = csum[ends] - csum[firsts]
    return (snode[firsts].astype(np.int32),
            sctg[firsts].astype(np.uint32),
            sref[firsts].astype(np.uint32),
            np.minimum(sums, 0xFFFF).astype(np.uint16))


def merge_edges_device(edge_from: np.ndarray, edge_to: np.ndarray,
                       edge_step: np.ndarray, n_nodes: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """Exact (from, to, step) dedup on the accelerator.  Returns the
    deduplicated arrays in (from, to, step)-ascending order (the spec's
    order), or None when a field exceeds int32 (caller falls back)."""
    n = len(edge_from)
    if n == 0:
        return None
    hi = np.iinfo(np.int32).max
    if (int(edge_step.min()) < 0 or int(edge_step.max()) >= hi
            or n_nodes >= hi):
        return None
    cap = _bucket(n)
    frm = np.full(cap, hi, np.int32)
    frm[:n] = edge_from
    to = np.full(cap, hi, np.int32)
    to[:n] = edge_to
    step = np.full(cap, hi, np.int32)
    step[:n] = edge_step
    sf, st, ss, boundary = [
        np.asarray(a)[:n] for a in _merge_edge_kernel(
            jnp.asarray(frm), jnp.asarray(to), jnp.asarray(step))]
    keep = np.flatnonzero(boundary)
    return (sf[keep].astype(np.int32), st[keep].astype(np.int32),
            ss[keep].astype(np.int32))
