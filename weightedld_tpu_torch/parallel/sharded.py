"""What stitches the shards of a session together: replicated operands and
the merges of the shards' per-batch results.

Counterpart of ``weightedld_tpu/parallel/sharded.py:1-538``.  The TPU
package stripes the tile plan over a 1-D mesh and runs one ``shard_map``
program per batch; here a session (``runtime/driver.py``) holds a list of
local shard devices, and each process runs its shards' batches one after
another through ``LdSession._dispatch`` (kernel, window masks, threshold,
compaction on the shard's device), the body of the TPU runner's
``local_fn`` (``:103-258``).  This module holds the rest:

* :func:`replicate`: the codes or planes, weights, aux and site-map copies
  go to each distinct local shard device once, at session set-up
  (``:34-37``); shards that share a device share its copies;
* :func:`allgather` / :func:`gather_shards` / :func:`broadcast`: the host
  collectives over the gloo group of ``parallel/multihost.py``, the
  counterpart of the driver's ``_fetch`` (``driver.py:248-259``);
* :func:`gather_records`, the counterpart of ``gather_compact``
  (``:480-538``): each shard's compacted records, concatenated in global
  shard order (process-major, then local order, as ``jax.devices()``
  orders a global mesh), so a batch's rows come out in the JAX session's
  order;
* the merges of ``make_topk_runner`` (``:301``), ``make_decay_runner``
  (``:392``) and ``make_hist_runner`` (``:450``) across shards, in the order
  the JAX session reads them.  The per-batch reductions themselves are in
  ``parallel/analytics.py``.
"""

from __future__ import annotations

import numpy as np

from .multihost import process_count


def replicate(devices, *tensors) -> list[tuple]:
    """Per local shard, ``tensors`` on its device (``None`` stays
    ``None``): one copy per distinct device, shared by the shards on it."""
    copies: dict[str, tuple] = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in copies:
            copies[key] = tuple(None if t is None else t.to(dev)
                                for t in tensors)
        out.append(copies[key])
    return out


def allgather(obj) -> list:
    """``obj`` of every process, in rank order (``[obj]`` with no process
    group)."""
    if process_count() == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_shards(local: list) -> list:
    """The per-shard lists of every process, concatenated in global shard
    order."""
    return [x for part in allgather(local) for x in part]


def broadcast(obj):
    """Process 0's ``obj`` on every process."""
    if process_count() == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_records(local: list[tuple[np.ndarray, np.ndarray]],
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One batch's records of every shard: ``local`` holds this process's
    ``(sites [n, 2] int64, values [n, 3] float32)`` per local shard; the
    result is every shard's rows, concatenated in global shard order."""
    parts = gather_shards(local)
    sites = np.concatenate([p[0] for p in parts], axis=0) if parts \
        else np.empty((0, 2), np.int64)
    vals = np.concatenate([p[1] for p in parts], axis=0) if parts \
        else np.empty((0, 3), np.float32)
    return sites, vals


def merge_moments(per_shard: list[np.ndarray]) -> tuple[int, int, float,
                                                        float]:
    """``(n_pairs, n_over, r2_sum, r2_max)`` of the shards' float64
    ``[4]`` moment totals (kept count, count over the threshold, r2 sum
    over it, kept r2 max), summed in shard order."""
    m = np.stack(per_shard)
    return (int(m[:, 0].sum()), int(m[:, 1].sum()), float(m[:, 2].sum()),
            float(m[:, 3].max()))


def merge_sums(per_shard: list[np.ndarray]) -> np.ndarray:
    """The decay ``[B, 4]`` or histogram ``[B]`` partial sums of every
    shard, added in shard order."""
    return np.sum(np.stack(per_shard), axis=0)


def merge_topk(cands: list[np.ndarray], k: int) -> np.ndarray:
    """The ``k`` strongest of the candidate rows ``(i, j, D, D', r2)``,
    descending r2, stable: ``cands`` is batch-major and shard-minor, the
    order the JAX session concatenates its per-batch ``[n_dev, k, 5]``
    blocks in, so ties keep that order."""
    cand = np.concatenate(cands, axis=0) if cands \
        else np.empty((0, 5), np.float64)
    return cand[np.argsort(-cand[:, 4], kind="stable")[:k]]
