"""Device (XLA) merge phases vs the numpy specification.

The device path (graph/merge_device.py) must produce bit-identical graph
state to PAGraph's in-file numpy spec for both merge phases — epsilon
position clustering (PABruijnGraph.cpp:259-274 semantics, deterministic
chain-cluster variant) and exact edge dedup (PABruijnGraph.cpp:285-297).
Runs on the CPU backend per conftest; the same jit runs on the GPU in
production.
"""

import numpy as np
import pytest

from aligngraph2_tpu.graph.pagraph import PAGraph


def _mk_graph(rng, n_nodes=64, k=5):
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    return PAGraph(codes, k)


def _rand_positions(rng, n, n_nodes, zero_frac=0.2, cluster_frac=0.5):
    node = rng.integers(0, n_nodes, n)
    base_c = rng.integers(0, 5000, n)
    base_r = rng.integers(0, 5000, n)
    # make many near-duplicates so clustering actually merges
    dup = rng.random(n) < cluster_frac
    base_c[dup] = (base_c[dup] // 700) * 700 + rng.integers(0, 12, dup.sum())
    base_r[dup] = (base_r[dup] // 700) * 700 + rng.integers(0, 12, dup.sum())
    base_c[rng.random(n) < zero_frac] = 0
    base_r[rng.random(n) < zero_frac] = 0
    return node, base_c, base_r


def _run_merge(g_args, monkeypatch, backend, epsilon):
    node, ctg, ref, codes, k = g_args
    g = PAGraph(codes, k)
    g.append_positions(node, ctg, ref)
    monkeypatch.setenv("ALIGNGRAPH2_TPU_MERGE", backend)
    removed = g.merge_positions(epsilon)
    return removed, g.pos_node, g.pos_ctg, g.pos_ref, g.pos_count


def test_device_path_actually_runs():
    """Guard against a silent fallback making the parity tests vacuous:
    the device entry points must return results, not None."""
    from aligngraph2_tpu.graph.merge_device import (merge_edges_device,
                                                    merge_positions_device)
    res = merge_positions_device(np.array([1, 1], np.int64),
                                 np.array([5, 6], np.uint64),
                                 np.array([5, 6], np.uint64),
                                 np.array([1, 1], np.int64), 10)
    assert res is not None and len(res[0]) == 1
    res = merge_edges_device(np.array([1, 1], np.int64),
                             np.array([2, 2], np.int64),
                             np.array([3, 3], np.int64), 16)
    assert res is not None and len(res[0]) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("epsilon", [0, 10])
def test_merge_positions_device_equals_spec(monkeypatch, seed, epsilon):
    rng = np.random.default_rng(seed)
    k, n_nodes = 5, 64
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    node, ctg, ref = _rand_positions(rng, 5000, n_nodes)
    args = (node, ctg, ref, codes, k)
    rm_spec, *spec = _run_merge(args, monkeypatch, "numpy", epsilon)
    rm_dev, *dev = _run_merge(args, monkeypatch, "device", epsilon)
    assert rm_spec == rm_dev
    for a, b in zip(spec, dev):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_positions_device_saturation(monkeypatch):
    """uint16 CountType saturation must match the spec."""
    k = 4
    codes = np.arange(16)
    n = 80000
    node = np.zeros(n, np.int64)
    ctg = np.full(n, 100, np.int64)
    ref = np.full(n, 200, np.int64)
    outs = []
    for backend in ("numpy", "device"):
        g = PAGraph(codes, k)
        g.append_positions(node, ctg, ref)
        monkeypatch.setenv("ALIGNGRAPH2_TPU_MERGE", backend)
        g.merge_positions(10)
        outs.append((g.pos_node.copy(), g.pos_count.copy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][1][0] == 0xFFFF


def test_merge_positions_uint32_wrap_values(monkeypatch):
    """Coordinates near the uint32 ceiling keep exact semantics."""
    k = 4
    codes = np.arange(16)
    hi = 0xFFFFFFFF
    node = np.array([3, 3, 3, 3], np.int64)
    ctg = np.array([hi, hi - 5, 1, 0], np.int64)
    ref = np.array([hi, hi - 5, 1, 0], np.int64)
    outs = []
    for backend in ("numpy", "device"):
        g = PAGraph(codes, k)
        g.append_positions(node, ctg, ref)
        monkeypatch.setenv("ALIGNGRAPH2_TPU_MERGE", backend)
        g.merge_positions(10)
        outs.append((g.pos_node.copy(), g.pos_ctg.copy(),
                     g.pos_ref.copy(), g.pos_count.copy()))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_merge_edges_device_equals_spec(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    k, n_nodes = 5, 64
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    n = 4000
    frm = rng.integers(0, n_nodes, n)
    to = rng.integers(0, n_nodes, n)
    step = rng.integers(1, 8, n)
    outs = []
    for backend in ("numpy", "device"):
        g = PAGraph(codes, k)
        g.append_edges(frm, to, step)
        monkeypatch.setenv("ALIGNGRAPH2_TPU_MERGE", backend)
        removed = g.merge_edges()
        outs.append((removed, g.edge_from.copy(), g.edge_to.copy(),
                     g.edge_step.copy()))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_array_equal(a, b)


def test_finalize_after_device_merge(monkeypatch):
    """finalize()'s CSR offsets are identical whether built from the
    device merge output (sorted-flag fast path) or the spec's re-sort."""
    rng = np.random.default_rng(9)
    k, n_nodes = 5, 64
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    node, ctg, ref = _rand_positions(rng, 3000, n_nodes)
    frm = rng.integers(0, n_nodes, 500)
    to = rng.integers(0, n_nodes, 500)
    step = rng.integers(1, 6, 500)
    outs = []
    for backend in ("numpy", "device"):
        g = PAGraph(codes, k)
        g.append_positions(node, ctg, ref)
        g.append_edges(frm, to, step)
        monkeypatch.setenv("ALIGNGRAPH2_TPU_MERGE", backend)
        g.merge_edges()
        g.merge_positions(10)
        g.finalize()
        outs.append(g)
    a, b = outs
    np.testing.assert_array_equal(a.pos_start, b.pos_start)
    np.testing.assert_array_equal(a.edge_start, b.edge_start)
    np.testing.assert_array_equal(a.pos_node, b.pos_node)
    np.testing.assert_array_equal(a.edge_from, b.edge_from)
    np.testing.assert_array_equal(a.edge_step, b.edge_step)
