"""Multi-host bootstrap and output collection.

SURVEY §5.8: the reference's only "communication" is host->device uploads
and GL interop readback on one machine.  The multi-host equivalents:

* :func:`initialize` — ``jax.distributed.initialize`` bootstrap so every
  process sees the global device set (controller-less SPMD; call first).
* :func:`gather_image` — the GL-interop role (getting pixels out) across
  hosts: all-gather the pixel-sharded image so every host holds the full
  frame (``multihost_utils.process_allgather``), or fetch only the
  local shard for per-host tile writes.
* :func:`local_tile_bounds` — which rows of the frame this process owns
  under the standard tiles-axis sharding, for per-host EXR/PNG tile output
  (the scalable path at 1080p+ on big slices).

Single-process runs (tests, one device) degrade to no-ops, so the render
scripts are identical from 1 device to N hosts — only the mesh changes.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Multi-host bootstrap; no-op when single-process (tests, 1 device).

    The guard must not touch jax state: ``jax.process_count()`` would
    initialise the XLA backend, after which ``jax.distributed.initialize``
    raises.  With a coordinator address we always bootstrap, even for
    num_processes=1 (so 1-vs-N process parity tests run the same path).
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def gather_image(img) -> np.ndarray:
    """Full frame on every host from a pixel-sharded device array."""
    if jax.process_count() == 1:
        return np.asarray(img)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))


def local_shard(img) -> np.ndarray:
    """Only this host's rows of a pixel-sharded image (no communication)."""
    shards = [s for s in img.addressable_shards]
    shards.sort(key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def local_tile_bounds(img) -> tuple[int, int]:
    """(start, stop) rows of the flattened pixel axis owned by this host."""
    starts = [s.index[0].start or 0 for s in img.addressable_shards]
    stops = [s.index[0].stop if s.index[0].stop is not None else img.shape[0]
             for s in img.addressable_shards]
    return min(starts), max(stops)
