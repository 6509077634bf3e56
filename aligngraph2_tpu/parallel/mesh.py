"""Device mesh construction.

The reference is single-node shared-memory threading (SURVEY.md §2.6); here
a 2-D ``jax.sharding.Mesh`` replaces it:

  * ``data``  — reads are data-parallel across this axis (the analogue of
    the reference's thread-striped read loops, Aligner.tcc:28-29);
  * ``block`` — the similar-genome seeding index is sharded by genome
    block across this axis (the analogue of mecat2ref+'s genome block
    decomposition, README.md:43-51), with candidate scores merged by
    all-gather across devices.
"""

from __future__ import annotations

import numpy as np
import jax


def make_mesh(n_devices: int | None = None, block_parallel: int | None = None,
              data_axis: str = "data", block_axis: str = "block",
              devices=None):
    """Build a (data, block) mesh over the available devices.

    ``block_parallel`` defaults to 2 when at least 4 devices are present,
    else 1 (all devices data-parallel).  ``devices`` overrides the
    device list — multi-host pipelines pass ``jax.local_devices()`` so
    hosts shard the files while each host's devices shard the
    seeds/extension (SURVEY.md §2.6); device_put of host-local numpy
    batches requires every mesh device to be addressable.
    """
    devs = jax.devices() if devices is None else list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if block_parallel is None:
        block_parallel = 2 if n >= 4 else 1
    if n % block_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"block_parallel={block_parallel}")
    arr = np.array(devs).reshape(n // block_parallel, block_parallel)
    return jax.sharding.Mesh(arr, (data_axis, block_axis))
