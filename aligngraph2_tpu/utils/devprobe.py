"""One-shot host<->device link probe for backend auto-selection.

The device graph-merge and consensus backends are bit-identical to the
host C++ cores.  Their wall time includes streaming their tables
between host and device, so whether they beat the host cores depends on
the link.  The dispatch default is "auto": measure the round-trip
bandwidth once per process (one 16 MB transfer each way) and pick the
device backend when the link clears DEVICE_MIN_MBPS, which a directly
attached GPU does.  Both backends have yet to be timed on the GPU; until
then the threshold is a guess, not a measurement.  Explicit
``ALIGNGRAPH2_TPU_MERGE`` / ``ALIGNGRAPH2_TPU_CONSENSUS`` values still
win; ``ALIGNGRAPH2_TPU_LINK_MBPS`` pins the measured value (and is the
test hook for faking link speeds).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

logger = logging.getLogger("aligngraph2_tpu.devprobe")

# device backends move about 2 bytes across the link per byte of work
# they take off the host cores; a directly attached card moves GB/s
DEVICE_MIN_MBPS = 500.0

_PROBE_BYTES = 16 << 20
_cached_mbps: float | None = None


def link_bandwidth_mbps() -> float:
    """Measured host->device->host round-trip bandwidth in MB/s
    (min of the two directions), cached for the process.

    ``ALIGNGRAPH2_TPU_LINK_MBPS`` overrides the measurement (user pin
    or test fake).  Returns 0.0 on the CPU backend."""
    global _cached_mbps
    env = os.environ.get("ALIGNGRAPH2_TPU_LINK_MBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if _cached_mbps is not None:
        return _cached_mbps
    import jax
    if jax.default_backend() == "cpu":
        _cached_mbps = 0.0
        return _cached_mbps
    arr = np.zeros(_PROBE_BYTES, np.uint8)
    dev = jax.device_put(arr)
    np.asarray(dev)            # warm both directions + sync
    t0 = time.perf_counter()
    dev = jax.device_put(arr)
    jax.block_until_ready(dev)
    t1 = time.perf_counter()
    np.asarray(dev)
    t2 = time.perf_counter()
    mb = _PROBE_BYTES / float(1 << 20)
    up = mb / max(t1 - t0, 1e-6)
    down = mb / max(t2 - t1, 1e-6)
    _cached_mbps = min(up, down)
    logger.info("device link probe: up %.0f MB/s, down %.0f MB/s", up, down)
    return _cached_mbps


def resolve_backend(env_var: str, default_auto: str = "auto") -> str:
    """Dispatch value for a device/native backend switch.

    Explicit env values pass through untouched; "auto" (the default)
    resolves to "device" when the measured link clears DEVICE_MIN_MBPS,
    else "native"."""
    val = os.environ.get(env_var, default_auto)
    if val != "auto":
        return val
    return ("device" if link_bandwidth_mbps() >= DEVICE_MIN_MBPS
            else "native")
