"""All-pairs LD driver over shards: batches of triangle tiles -> records.

Counterpart of a subset of ``weightedld_tpu/runtime/driver.py``:
``DriverConfig`` (the fields this port uses, the window and cross fields
of ``driver.py:87-97`` among them), ``LdSession`` (the kernel decisions of
``driver.py:364-411``, the cross validations and both unsafe-site packings
of ``:412-487`` with the windowed gate ``_windowed_packing_pays`` of
``:288-313``, the plan choice of ``:545-561``, the hybrid safe/unsafe
tile-pair split of ``:575-604``, the original-index lookup of ``:755-761``,
the two-phase plan of ``:830-886`` and the site-map validation of
``_ensure_sm_dev``, ``:920-951``; batch dispatch with the keep / threshold
/ moments step of ``parallel/sharded.py:154-218``, the site-index, lookup,
bp and rectangle masks of ``:155-194`` included; ``summarize``, ``stream``
and the analytics of
``:1344-1641``: ``ld_decay``, ``r2_histogram``, ``top_pairs``, ``prune`` and
``matrices``), ``SiteMajorCodes`` and ``LdSession.required_padding``
(``driver.py:50-66, 889-918``), ``Progress`` and the ``on_progress``
reports of ``stream`` (``:273-287, 1680-1700``), ``validate_decay_edges`` /
``validate_hist_edges``, ``stream_ld_records``, ``collect_ld_records``
(``:1751-1774``) and ``run_to_tsv`` with its checkpoint (``:1776-1975``),
and the shard geometry of ``driver.py:852-877`` (``stripe`` per phase).

Which kernel runs (``ops/cuda_ld.py``, factorized; ``ops/cuda_general.py``,
general per-pair):

* no UNKNOWN code anywhere (every VCF matrix, FASTA without ambiguity
  characters), or UNKNOWNs whose per-site count margins absorb the worst
  per-pair removals: the factorized kernel over the whole triangle;
* otherwise the UNKNOWN-carrying sites are packed into the trailing tiles
  and the plan splits by tile pair: phase 0, the tile pairs whose margins
  make the factorized kernel exact, then phase 1, the rest, on the general
  kernel (all of the triangle when no tile pair is safe);
* ``kernel="general"``: the general kernel over the whole triangle.

That is the ``"pallas"`` engine, which ``DriverConfig.engine="auto"``
resolves to on every device.  ``engine="xla"`` runs the JAX package's
portable tile engine instead (its XLA branch, ``driver.py:785-806``):
``core/ld_tiled.tile_stats_batch`` over sequence-major codes padded with
UNKNOWN sites and float32 weights, at an auto tile of 128, with no
packing, split, planes or weight quantization; every batch loop, mask and
merge below is the same.

A session uploads the padded site-major codes, the packed weights, the
per-site aux and the tile plan once; each batch then runs one kernel
launch, thresholds, and compacts its records on the device.  Its input is
an ``[N, S]`` code matrix, which it transposes and pads on the host, or a
:class:`SiteMajorCodes` buffer already in that layout (the streaming
ingest, ``runtime/ingest.py``), which it uploads as it is; every per-site
host step (plane detection, histograms, kernel choice, aux, the MAF) reads
that buffer, and the packing permutation is applied to the codes on the
device, so the host holds one matrix.  ``weights=None`` computes the
Henikoff weights on the device from the uploaded codes
(``henikoff_weights_site_major``).  Records stream
in plan order — phase 0, then phase 1; tile order, then (row, col) inside a
tile — as the JAX session on one device emits them, with the packing
permutation folded back into each record's endpoints.

Windowed (``max_site_distance``, ``max_bp_distance``) and cross
(``cross_split``) sessions prune the tile plan (``parallel/triangle.py``)
and fold the in-tile remainder into each batch's ``keep`` in
:meth:`LdSession._dispatch`, so records, ``summarize`` and every analytics
method see one pair set.  Under a window the unsafe-site packing is the
order-preserving class split (clean sites, then dirty sites, each in input
order) on a plan of per-tile position intervals, where it pays; a cross
session never packs.

The batch loop is pipelined as the JAX session's (``_pipelined``,
``_pipelined_reduce``, ``driver.py:1209-1310``): batch b + 1 is launched,
on every local shard, before anything of batch b is read, and each batch's
small results (the reductions' moments, bins or top-k rows; a stream's
survivor count and record block) start their copy to the host when they
are launched (pinned buffers and ``non_blocking`` copies on CUDA, one
event per shard slice), so the host waits for batch b while batch b + 1
computes.  ``stream`` compacts into a speculative capacity learned per
batch and per shard (``driver.py:1051-1114, 1248-1288``), with no host
read; a batch whose count exceeds its capacity, or that was never seen,
takes the exact path (``torch.nonzero``) from its stat tensors, which the
loop keeps until the batch is read.  ``stream(decimals=d)`` rounds D and
r2 to d decimals on the device, in both compactions (``core/ld_tiled.py``);
``run_to_tsv`` streams so for 0 <= ndigits <= 4.

Shards.  ``LdSession(devices=[...])`` takes this process's shard devices
(one by default; repeats allowed, several shards then share a device), and
under a process group (``parallel/multihost.py``) every process holds its
own; the global shard count is ``G = process_count() * len(devices)``.
Each phase's tiles are striped over the G shards (``stripe``: shard d owns
tiles d, d + G, ...), and batch b is every shard's slice ``[b k, (b + 1)
k)`` of its own tiles, k tiles per shard.  Each process launches its local
shards' slices of a batch through :meth:`LdSession._dispatch`, each with
the device work of its reduction, before it reads any result back
(:meth:`LdSession._launch_shards`): slices on different cards then run at
once, as the JAX session runs a batch on every mesh device in one
``shard_map``.  The reads go in shard order, and the shards' host results
are merged in global shard order (``parallel/sharded.py``): a batch's
records are shard 0's, then shard 1's, ..., which is the JAX session's
order on a G-device mesh.  On one
shard this is plan order; over several it depends on k as well, whose
auto value differs between the CPU and the card (as the JAX package's
does between the CPU and a TPU), so two runs over G > 1 shards write the
same bytes at the same k.

Spans (:func:`runtime.profiling.span`, recorded while a profiler records
the process): ``upload.scan``, ``.pack``, ``.plan``, ``.copy``,
``.weights``, ``.planes`` and ``.sync`` in the constructor;
``batch.kernel`` and ``batch.reduce`` (with device times),
``batch.wait``, ``batch.read`` (one per shard slice, with its compaction
path) and ``batch.gather`` in the batch loops; ``prune.sweep``; and a
``query.<method>`` span around each public query method (``prune``'s
scan is a ``query.stream`` inside its ``query.prune``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from contextlib import nullcontext
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from ..core.henikoff import henikoff_weights, henikoff_weights_site_major
from ..core.ld_dense import LdRecords
from ..core.ld_tiled import (
    compact_fixed,
    compact_tile_stats,
    decode_block,
    pad_alignment,
    threshold_mask,
    tile_stats_batch,
)
from ..core.sites import site_histogram_host, site_histogram_host_site_major
from ..device import resolve_device
from ..ops.cuda_general import (
    build_planes_tiled,
    tile_stats_general,
    tile_stats_general_plain,
)
from ..ops.cuda_ld import (
    build_majmin_planes,
    build_majmin_xq,
    detect_planes_unknown,
    majmin_safe_with_unknown,
    majmin_site_aux,
    majmin_site_margins,
    majmin_tile_margins,
    pad_alignment_site_major,
    pad_weights,
    pad_weights_int8,
    pad_weights_lo_int8,
    tile_stats_majmin,
    tile_stats_majmin_plain,
    tile_stats_majmin_pre,
    tile_stats_majmin_pre_plain,
    weights_bf16_exact,
)
from ..parallel.analytics import decay_batch, hist_batch, topk_batch
from ..parallel.multihost import (
    global_shard_count,
    is_output_process,
    process_count,
    process_index,
)
from ..parallel.sharded import (
    allgather,
    broadcast,
    gather_records,
    gather_shards,
    merge_moments,
    merge_sums,
    merge_topk,
    replicate,
)
from ..parallel.triangle import cdiv, plan_tiles, plan_tiles_permuted, stripe
from .profiling import span, spanned

log = logging.getLogger("weightedld_tpu_torch")

_UNSET = object()  # "use the session default" sentinel (None is meaningful)

# The factorized kernel stages 64 sequence columns per step in its float
# modes (bf16 operands) and 128 in its integer modes (Geom::kCols in
# csrc/ld_majmin.cu): a partial step costs a whole one, so padding N up to a
# multiple of 64 is free, and 64-column chunks keep every staged row 16-byte
# aligned (16-byte cp.async staging).
SEQ_CHUNK_STEP = 64
# Largest chunk whose int32 joints convert to f32 exactly under the int8
# cascade (|J| <= 127 * chunk < 2^24): the f32 combine then rounds only in
# the scale products and sums, as with the JAX package's <= 2,048 chunks.
MAX_SEQ_CHUNK = 131072
DEFAULT_TILE = 256
# The XLA tile engine's auto tile: the JAX package's off-TPU value
# (driver.py:245), so a default run's row order is the JAX engine's.
XLA_TILE = 128
ENGINES = ("auto", "pallas", "xla")
# Device bytes per site pair of one batch: d, d' and r2 float32 plus keep.
# The window and cross masks each allocate one bool per pair while they
# fold into keep, freed before the threshold mask: no higher peak.
_STAT_BYTES = 13
# |distance| bound of the in-tile masks: site indices and int32 positions
# differ by less than 2^32, so a larger window keeps every pair (and the
# int64 sums stay far from overflow).
_MASK_CLAMP = 1 << 32
# The XLA tile engine's device working set per batch and shard (the
# one-hot operands, the joint tables and the finalize's temporaries), and
# its bytes per site pair beyond the operands: Jw and Ju (2 x 25 float32)
# and the finalize's [K, T, T] and [K, T, T, 5] temporaries (~250 B at
# their peak), the stats and the threshold mask of the two batches a
# stream holds (2 x 14 B).
_XLA_BATCH_BYTES = 4 << 30
_XLA_PAIR_BYTES = 512
# Speculative-compaction capacity ceiling, records per shard and batch (the
# JAX value, ``driver.py:47``): a block of 2^22 records is 84 MB of pinned
# host buffer per slice in flight; a batch past it takes the exact path.
_SPEC_CAP_MAX = 1 << 22


@dataclass(frozen=True)
class SiteMajorCodes:
    """An alignment already in the session's padded SITE-MAJOR layout, the
    input of the streaming ingest (copy of ``driver.py:50-66``).

    ``codes`` is ``[s_pad, n_pad]`` int8, UNKNOWN-padded on both axes, with
    ``codes[s, k] == alignment[k, s]`` for the readers' ``alignment``.
    ``(s_pad, n_pad)`` must be :meth:`LdSession.required_padding`'s for the
    session's config; the session raises otherwise (a larger buffer would
    sweep dead sequence chunks and desync the padded weights)."""

    codes: np.ndarray
    n_seqs: int
    n_sites: int


@dataclass
class DriverConfig:
    tile: int | None = None         # site-tile side (None = auto: 256;
                                    # 128 under engine="xla")
    tiles_per_shard_batch: int | None = None  # tiles per dispatch (None =
                                    # auto: a 2 GiB stats budget on CUDA,
                                    # 4 GiB of working set under
                                    # engine="xla", 8 on the CPU)
    r2_threshold: float | None = None  # None = emit every surviving pair
    progress_every_s: float = 10.0  # least seconds between on_progress
                                    # reports (the last batch always
                                    # reports)
    engine: str = "auto"            # auto | pallas | xla: "auto" and
                                    # "pallas" = the CUDA kernels on the
                                    # card, their plain versions on the
                                    # CPU; "xla" = the JAX package's
                                    # portable tile engine
                                    # (core/ld_tiled.tile_stats_batch,
                                    # float32 matrix products) on the
                                    # session's device
    seq_chunk: int | None = None    # sequence columns per f32 combine (None
                                    # = auto: all of N in one chunk, see
                                    # resolve_seq_chunk)
    weight_quant: str = "none"      # weighted-pass arithmetic: "none" =
                                    # the int8x3 cascade (full accuracy) |
                                    # "split_bf16" | "lo_int8" | "int8"
                                    # (the last two lossy)
    preplaned: str = "auto"         # "auto": precomputed maj/dmin (+ xq)
                                    # planes for the factorized kernel when
                                    # they fit (plane_budget) and the seq
                                    # chunk is a multiple of 16 (see
                                    # auto_preplaned) | "on": planes
                                    # for every kernel the session runs,
                                    # the general kernel's one-hot planes
                                    # included | "off": codes only
    kernel: str = "auto"            # "auto": the factorized kernel (or the
                                    # hybrid tile-pair split) wherever
                                    # exactness is proven | "general": the
                                    # general per-pair kernel everywhere
    max_site_distance: int | None = None  # windowed LD (kept-site indices)
    max_bp_distance: int | None = None  # windowed LD in site_map units (bp
                                    # for VCF, PLINK-style; original column
                                    # indices for FASTA); needs a
                                    # non-decreasing site_map; composes
                                    # with max_site_distance (intersection)
    cross_split: int | None = None  # rectangular (inter-region) mode: only
                                    # pairs (a, b) with layout index a <
                                    # cross_split <= b (the CLI's
                                    # --cross-regions); no packing, and
                                    # exclusive with the window fields


@dataclass
class Progress:
    """A scan's progress (copy of ``driver.py:273-287``).  Work is counted
    in evaluated pairs (emitted tiles x T^2), what throughput means however
    many records pass the threshold; ``records_emitted`` counts the
    survivors."""

    pairs_done: int       # pairs evaluated so far (emitted tiles * T^2)
    pairs_total: int      # pairs the plan evaluates
    records_emitted: int  # records surviving keep + threshold so far
    elapsed_s: float

    @property
    def pairs_per_s(self) -> float:
        return self.pairs_done / self.elapsed_s if self.elapsed_s > 0 else 0.0


@dataclass(frozen=True)
class _Phase:
    """One kernel's share of the plan, striped and uploaded once:
    ``kernel`` is ``"majmin"`` or ``"general"``, ``n_tiles`` its real tile
    pairs, ``k`` its tiles per shard and batch.  ``tile_i_host``,
    ``tile_j_host`` and ``emit_host`` are the ``[G, n_batches * k]`` plan
    tables of every shard (``matrices`` reads them);
    ``tile_i``, ``tile_j`` and ``emit`` hold one ``[n_batches * k]``
    tensor per local shard, on its device."""

    kernel: str
    n_tiles: int
    k: int
    n_batches: int
    tile_i_host: np.ndarray
    tile_j_host: np.ndarray
    emit_host: np.ndarray
    tile_i: list
    tile_j: list
    emit: list


def validate_decay_edges(edges) -> tuple:
    """LD-decay bin edges, checked before any upload (copy of
    ``driver.py:143-155``): integers, ascending, >= 2 entries, within int32
    (the device distance dtype)."""
    edges = tuple(int(e) for e in edges)
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"edges must be ascending with >= 2 entries, got {edges}")
    lim = np.iinfo(np.int32)
    if edges[0] < lim.min or edges[-1] > lim.max:
        raise ValueError(
            f"edges must fit int32 (device distance dtype), got {edges}")
    return edges


def validate_hist_edges(edges) -> tuple:
    """r2-histogram bin edges, checked before any upload (copy of
    ``driver.py:158-167``): floats, ascending, >= 2 entries."""
    edges = tuple(float(e) for e in edges)
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"edges must be ascending with >= 2 entries, got {list(edges)}")
    return edges


def _resolve_engine(engine: str) -> str:
    """The engine a session runs: ``"auto"`` is ``"pallas"`` on every
    device of the port, the hand-written CUDA kernels on the card and their
    plain versions on the CPU (the JAX package resolves ``"auto"`` to
    ``"xla"`` off a TPU, ``driver.py:130-140``: the kernels are the port's
    reason to exist).  ``"xla"`` runs only when asked for.  Unlike the JAX
    package, which sends any other string to its XLA branch, another value
    raises ``ValueError``."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be auto|pallas|xla, got {engine!r}")
    return "pallas" if engine == "auto" else engine


def resolve_tile(tile: int | None, engine: str = "pallas",
                 alignment: np.ndarray | None = None, seq_chunk: int = 512,
                 planes: tuple | None = None, platform: str | None = None,
                 majmin: bool = False, n_seqs: int | None = None) -> int:
    """Site-tile side.  Auto: 128 under the XLA engine (the JAX package's
    value off a TPU, ``driver.py:245``), else 256.  The signature is JAX's
    (``driver.py:212-215``), so a JAX call such as ``resolve_tile(None,
    "auto", aln)`` works; ``alignment``, ``seq_chunk``, ``planes``,
    ``platform``, ``majmin`` and ``n_seqs`` are accepted and not consulted
    (the port has one platform, and its tile has no N band: JAX's T = 512
    band for factorized sessions at 512 < N <= 2,048 was measured on a
    TPU).  On the H100 the tile only sets the
    granularity of the plan, of the ``[K, T, T]`` batch outputs and of the
    diagonal waste: the factorized kernel's CTA covers a 64 x 32 pair block
    in every weight mode whatever T is (any multiple of 64 keeps every
    thread busy).  At T = 256 a diagonal
    tile wastes half of 2^16 pairs, < 1% of the work for S >= 16k, and the
    plan stays small (18,528 tiles at S = 49,152).  An explicit ``tile``
    always wins."""
    del alignment, seq_chunk, planes, platform, majmin, n_seqs
    if tile is not None:
        return tile
    return XLA_TILE if _resolve_engine(engine) == "xla" else DEFAULT_TILE


def resolve_seq_chunk(seq_chunk: int | None, n_seqs: int) -> int:
    """Auto sequence chunk: one chunk for all of N, rounded up to the
    kernels' 64-column step, split evenly only past ``MAX_SEQ_CHUNK``.  On
    the H100 a chunk boundary costs only the per-pair f32 combine (4 cells
    x levels), so fewer chunks are never slower, and padding stays under
    64 columns per chunk.  An explicit ``seq_chunk`` always wins."""
    if seq_chunk is not None:
        return seq_chunk
    n_chunks = cdiv(max(n_seqs, 1), MAX_SEQ_CHUNK)
    per = cdiv(max(n_seqs, 1), n_chunks)
    return cdiv(per, SEQ_CHUNK_STEP) * SEQ_CHUNK_STEP


def resolve_tiles_per_batch(tiles_per_batch: int | None, n_tiles: int,
                            tile: int, r2_threshold: float | None,
                            device: torch.device, n_shards: int = 1) -> int:
    """Tiles per shard and dispatch, at most a shard's share of the plan
    (``n_tiles / n_shards``, as ``driver.py:617-633`` sizes k with
    ``n_dev``).  On CUDA: as many as fit a 2 GiB budget of batch
    outputs (13 B per pair; the threshold mask and the compaction add about
    as much again), a few GiB of the card's 80 GB.  At T = 256 that is
    2,520 tiles = 161,280 CTAs per launch, over a thousand waves on 132 SMs,
    so the per-batch launch and host round trip are amortized.  Without an
    r2 threshold every kept pair becomes a record (~40 B of device and host
    temporaries), so batches are capped at 1 GiB of records as well.  On
    the CPU (plain PyTorch path): 8 tiles, which bounds the float64 operand
    copies.  An explicit value always wins.

    The budget is per shard and is not divided among shards that share a
    card.  A session launches every local shard's slice of a batch before
    it reads any (:meth:`LdSession._launch_shards`), and batch b + 1
    before it reads batch b (:meth:`LdSession._pipelined`).  So under
    ``stream`` and ``matrices``, which read the ``[K, T, T]`` outputs
    themselves, a shard holds two batches: the one being read (kept for
    its exact path) and the next, each with its threshold mask (13 + 1 B
    per pair), and one compaction's word counts and their prefix at a
    time (2 B per pair): 30 B per pair, ~5.0 GB per shard at the auto
    2,520 tiles of T = 256.  (The JAX session holds three,
    ``driver.py:611-630``; the port drops a batch once it is read, before
    the next launch.)  The cohort (5,008 x 49,152, one shard) then holds
    ~2.0 GB of preplaned planes and xq plus ~5.0 GB, and G = 2 on one
    card ~9.9 GB plus one shared copy of the operands: both within the
    half of the card that :func:`plane_budget` leaves.  The reductions (``summarize`` and the
    analytics) free a slice's outputs once its reduction is launched, so
    they hold one slice's outputs at a time."""
    if tiles_per_batch is not None:
        return tiles_per_batch
    share = cdiv(n_tiles, n_shards)
    if device.type != "cuda":
        return max(1, min(8, share))
    t2 = tile * tile
    cap = max(1, (1 << 31) // (t2 * _STAT_BYTES))
    if r2_threshold is None:
        cap = min(cap, max(1, (1 << 30) // (t2 * 40)))
    return max(1, min(cap, share))


def resolve_xla_tiles_per_batch(tiles_per_batch: int | None, n_tiles: int,
                                tile: int, n_rows: int,
                                r2_threshold: float | None,
                                device: torch.device,
                                n_shards: int = 1) -> int:
    """Tiles per shard and dispatch of the XLA tile engine, at most a
    shard's share of the plan.  On the CPU: 8, the JAX package's value
    (``driver.py:633``).  On CUDA: as many as fit ``_XLA_BATCH_BYTES`` of
    working set, each tile pair taking its two one-hot ``[N, 5T]`` float32
    operands and their bool predecessor (45 B per sequence row and site)
    and ``_XLA_PAIR_BYTES`` per site pair: 303 tiles at T = 128 and N =
    1,000, whose batch peaks at 2.5 GiB on the H100 (``PERF.md``).  Without an r2 threshold the records cap it as in
    :func:`resolve_tiles_per_batch`.  The budget is fixed, not read from
    the card, so that a checkpoint resumes at the same k.  An explicit
    value always wins."""
    if tiles_per_batch is not None:
        return tiles_per_batch
    share = cdiv(n_tiles, n_shards)
    if device.type != "cuda":
        return max(1, min(8, share))
    t2 = tile * tile
    cap = max(1, _XLA_BATCH_BYTES // (45 * n_rows * tile
                                      + _XLA_PAIR_BYTES * t2))
    if r2_threshold is None:
        cap = min(cap, max(1, (1 << 30) // (t2 * 40)))
    return max(1, min(cap, share))


def plane_budget(device: torch.device) -> int:
    """Bytes the preplaned planes (+ xq) may take under ``preplaned="auto"``
    (:func:`auto_preplaned`): half the card's free memory; the other half
    holds the codes during the plane build and the batch outputs.  The
    preplaned entry's set-up costs no more than the codes entry's on the
    H100 (PERF.md), so memory and the seq chunk decide.  On the CPU: 0, so
    the plain versions run from the codes and build no planes."""
    if device.type != "cuda":
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    return free // 2


def auto_preplaned(seq_chunk: int, plane_bytes: int, budget: int) -> bool:
    """Whether ``preplaned="auto"`` takes the factorized kernel's preplaned
    entry: when its planes (+ xq) fit ``budget`` bytes (``plane_budget``)
    and the seq chunk is a multiple of 16, in every weight mode.  Whole
    sessions on the H100 (PERF.md): the preplaned entry scans faster at
    every auto chunk measured (int8x3 1.04-1.40x, lo_int8 and split_bf16
    1.03-1.11x), where its operand rows are read 16 bytes at a time; at a
    chunk that is not a multiple of 16 they are read 4 bytes at a time and
    the codes entry is the faster (int8x3 3.4x, the float modes
    1.13-1.14x)."""
    return plane_bytes <= budget and seq_chunk % 16 == 0


def _windowed_packing_pays(bad: np.ndarray, cfg: DriverConfig,
                           sm_arr: np.ndarray, n_sites: int) -> bool:
    """Cost gate of the windowed packing (copy of ``driver.py:288-313``).
    Packing moves the D dirty sites into trailing tiles whose position
    intervals span nearly everything, so each dirty tile pairs with nearly
    every block on the general kernel while the clean band (about W wide)
    turns factorized; the trade pays when ``2 * D <= W_eff``, W_eff the
    window in sites (for a bp window, the mean site count per window)."""
    n_dirty = int(bad.sum())
    w_eff = n_sites
    if cfg.max_site_distance is not None:
        w_eff = min(w_eff, int(cfg.max_site_distance))
    if cfg.max_bp_distance is not None:
        if sm_arr.size and bool((np.diff(sm_arr) < 0).any()):
            # A bp window needs a non-decreasing map anyway (the session
            # refuses it later); do not permute first.
            return False
        spans = (np.searchsorted(sm_arr, sm_arr + int(cfg.max_bp_distance),
                                 side="right")
                 - np.arange(n_sites) - 1)
        w_eff = min(w_eff, int(spans.mean()))
    return 2 * n_dirty <= w_eff


def packing_permutation(site_counts: np.ndarray, n_seqs: int,
                        cfg: DriverConfig | None = None,
                        site_map: np.ndarray | None = None,
                        ) -> np.ndarray | None:
    """The unsafe-site packing (``driver.py:457-487``); None when every
    site or no site is dirty (has an UNKNOWN cell), the order does not
    change, or a windowed packing does not pay.  Dirty sites are the only
    ones that can make a tile pair unsafe for the factorized kernel, so
    packing them into the trailing tiles leaves every clean x clean tile
    pair — the bulk of the triangle — on the factorized kernel.

    Without a window in ``cfg``: clean sites by descending stability
    margin, then dirty sites by ascending UNKNOWN count, both stable, which
    puts the weakest-margin clean sites in as few tiles as possible.  Under
    a window: the order-preserving class split, clean sites then dirty
    sites, each in input order, so the clean block keeps its ascending
    positions and its band; gated by :func:`_windowed_packing_pays` on
    the input-order ``site_map``."""
    margin, u = majmin_site_margins(site_counts, n_seqs)
    bad = u > 0
    if not bad.any() or bad.all():
        return None
    clean = np.flatnonzero(~bad)
    dirty = np.flatnonzero(bad)
    if cfg is not None and (cfg.max_site_distance is not None
                            or cfg.max_bp_distance is not None):
        if not _windowed_packing_pays(bad, cfg, np.asarray(site_map),
                                      len(bad)):
            return None
        perm = np.concatenate([clean, dirty])
    else:
        perm = np.concatenate([
            clean[np.argsort(-margin[clean], kind="stable")],
            dirty[np.argsort(u[dirty], kind="stable")]])
    if np.array_equal(perm, np.arange(len(perm))):
        return None
    return perm


class LdSession:
    """Device-resident all-pairs LD session over this process's shards.

    Uploads the alignment (site-major, padded), the packed weights, the
    per-site aux and the tile plan once to each shard device; each
    :meth:`stream` or :meth:`summarize` pass then runs one kernel launch
    per batch and local shard.

    ``alignment`` is an ``[N, S]`` code matrix or a :class:`SiteMajorCodes`
    buffer sized by :meth:`required_padding`.  ``weights=None`` computes
    the Henikoff weights on the device from the uploaded codes (float32
    cells; exposed as ``session.weights``).  ``devices`` is the list of
    local shard devices (default ``[device]``); every process of a
    process group must pass as many."""

    def __init__(self, alignment: np.ndarray | SiteMajorCodes,
                 weights: np.ndarray | None, site_map: np.ndarray,
                 cfg: DriverConfig | None = None,
                 device: str | torch.device | None = None,
                 devices=None):
        cfg = cfg or DriverConfig()
        if devices is None:
            devices = [device]
        if not len(devices):
            raise ValueError("devices must name at least one shard device")
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        self.n_local = len(self.devices)
        self.n_procs = process_count()
        self.n_shards = global_shard_count(self.n_local)
        self.engine = _resolve_engine(cfg.engine)
        sm = alignment if isinstance(alignment, SiteMajorCodes) else None
        if sm is not None and self.engine != "pallas":
            raise ValueError(
                "SiteMajorCodes input requires the pallas engine "
                f"(resolved engine: {self.engine!r})")
        if sm is not None:
            self.n_seqs, self.n_sites = sm.n_seqs, sm.n_sites
            want = self.required_padding(self.n_seqs, self.n_sites, cfg)
            if tuple(sm.codes.shape) != want or sm.codes.dtype != np.int8:
                raise ValueError(
                    f"SiteMajorCodes buffer {sm.codes.dtype} "
                    f"{tuple(sm.codes.shape)} does not match the session's "
                    f"padding int8 {want} (tile={resolve_tile(cfg.tile)}, "
                    f"seq_chunk="
                    f"{resolve_seq_chunk(cfg.seq_chunk, self.n_seqs)}); size "
                    "it with LdSession.required_padding(n_seqs, n_sites, "
                    "cfg)")
            # The padding is UNKNOWN by contract: only the valid region
            # decides the planes and whether any UNKNOWN is present.
            valid = sm.codes[:self.n_sites, :self.n_seqs]
        else:
            alignment = np.asarray(alignment)
            if alignment.ndim != 2:
                raise ValueError("alignment must be an [N, S] code matrix")
            self.n_seqs, self.n_sites = alignment.shape
            valid = alignment
        # The host input in the caller's site order, kept (no copy) for the
        # per-site histograms and prune's MAF, released once that is known.
        self._host = sm if sm is not None else alignment
        if cfg.weight_quant not in ("none", "split_bf16", "lo_int8", "int8",
                                    "int8x3"):
            raise ValueError(
                f"weight_quant must be none|split_bf16|lo_int8|int8|int8x3, "
                f"got {cfg.weight_quant!r}")
        if cfg.preplaned not in ("auto", "on", "off"):
            raise ValueError(
                f"preplaned must be auto|on|off, got {cfg.preplaned!r}")
        if cfg.kernel not in ("auto", "general"):
            raise ValueError(
                f"kernel must be 'auto' or 'general', got {cfg.kernel!r}")

        # No UNKNOWN anywhere: per-pair major/dmin are per-site properties
        # and the factorized kernel is exact.  With UNKNOWNs it still is
        # when every site's count margins absorb the worst per-pair
        # removals.  kernel="general" skips the factorized selection.  The
        # XLA engine decides none of this, so it never packs or splits the
        # plan (JAX decides them under its pallas engine only,
        # driver.py:370-411, :587).
        self.planes = None
        majmin = False
        site_counts = None
        if self.engine == "pallas":
            with span("upload.scan", cells=self.n_seqs * self.n_sites):
                self.planes, has_unknown = detect_planes_unknown(valid)
                if cfg.kernel == "auto":
                    if not has_unknown:
                        majmin = True
                    else:
                        site_counts = self._host_counts()
                        majmin = majmin_safe_with_unknown(
                            None, site_counts, n_seqs=self.n_seqs)
        del valid
        if cfg.cross_split is not None:
            if not 0 < cfg.cross_split < self.n_sites:
                raise ValueError(
                    f"cross_split must be in 1..{self.n_sites - 1}, got "
                    f"{cfg.cross_split}")
            if (cfg.max_site_distance is not None
                    or cfg.max_bp_distance is not None):
                raise ValueError(
                    "cross_split does not compose with the window flags "
                    "(a rectangle already bounds the pair set; distances "
                    "across a region boundary are ill-defined for "
                    "multi-chromosome layouts)")
        site_map = np.asarray(site_map)
        # The packing permutes the sites' rows of the codes on the device
        # (after the upload), the site map and the histogram here.  A cross
        # session never packs: its layout order is the rectangle.  Unlike
        # the JAX session, a streamed (SiteMajorCodes) one packs too, so
        # its records equal the standard session's.
        self.site_perm = None
        self.windowed_packed = False
        self._sm_orig_nondecr = None
        if (not majmin and site_counts is not None
                and cfg.cross_split is None):
            with span("upload.pack"):
                perm = packing_permutation(site_counts, self.n_seqs, cfg,
                                           site_map)
            if perm is not None:
                self._sm_orig_nondecr = not bool((np.diff(site_map) < 0)
                                                 .any())
                site_map = site_map[perm]
                site_counts = site_counts[perm]
                self.site_perm = perm
                self.windowed_packed = (cfg.max_site_distance is not None
                                        or cfg.max_bp_distance is not None)

        tile = resolve_tile(cfg.tile, self.engine)
        seq_chunk = resolve_seq_chunk(cfg.seq_chunk, self.n_seqs)
        cfg = replace(cfg, tile=tile, seq_chunk=seq_chunk)
        self.cfg = cfg
        self.site_map = site_map
        self._maf_cache = None
        self._sm_dev = self._sm_reps = None
        if cfg.max_bp_distance is not None:
            # The site map is validated before any plan or upload work; its
            # device copy serves the bp mask and ld_decay.
            self._site_map_dev("--max-distance-bp")
        with span("upload.plan"):
            if self.windowed_packed:
                self.plan = plan_tiles_permuted(
                    self.n_sites, tile, cfg.max_site_distance,
                    max_bp_distance=cfg.max_bp_distance,
                    orig_idx=self.site_perm, site_map=site_map)
            else:
                self.plan = plan_tiles(
                    self.n_sites, tile, cfg.max_site_distance,
                    max_bp_distance=cfg.max_bp_distance, site_map=site_map,
                    cross_split=cfg.cross_split)
            if self.engine == "xla":
                k = resolve_xla_tiles_per_batch(
                    cfg.tiles_per_shard_batch, self.plan.n_tiles, tile,
                    self.n_seqs, cfg.r2_threshold, self.device, self.n_shards)
            else:
                k = resolve_tiles_per_batch(cfg.tiles_per_shard_batch,
                                            self.plan.n_tiles, tile,
                                            cfg.r2_threshold, self.device,
                                            self.n_shards)
            cfg = replace(cfg, tiles_per_shard_batch=k)
            self.cfg = cfg
            # The hybrid split: a tile pair is factorized-exact when each
            # side's margins absorb the other side's UNKNOWN counts
            # (majmin_tile_margins); clean x clean tile pairs always are.
            self.hybrid_safe = None
            if not majmin and site_counts is not None:
                stab, umax = majmin_tile_margins(site_counts, self.n_seqs,
                                                 tile, self.plan.grid)
                pti, ptj = self.plan.tile_i, self.plan.tile_j
                safe = (((umax[ptj] == 0) | (stab[pti] > umax[ptj]))
                        & ((umax[pti] == 0) | (stab[ptj] > umax[pti])))
                if safe.all():
                    majmin = True  # weaker than the global test, still exact
                elif safe.any():
                    self.hybrid_safe = safe
            if self.engine == "xla":
                parts = [("xla", np.ones(self.plan.n_tiles, bool))]
            elif majmin:
                parts = [("majmin", np.ones(self.plan.n_tiles, bool))]
            elif self.hybrid_safe is not None:
                parts = [("majmin", self.hybrid_safe),
                         ("general", ~self.hybrid_safe)]
            else:
                parts = [("general", np.ones(self.plan.n_tiles, bool))]
            kernels = {kern for kern, _sel in parts}
        # The permuted site-index window reads each pair's original indices
        # (driver.py:755-761); padding sites are dropped by keep anyway.
        self._orig_dev = None
        if self.windowed_packed and cfg.max_site_distance is not None:
            orig = np.zeros(self.plan.s_pad, dtype=np.int64)
            orig[:self.n_sites] = self.site_perm
            self._orig_dev = torch.from_numpy(orig).to(self.device)

        if self.engine == "xla":
            self._upload_xla(alignment, weights)
        else:
            n_pad = cdiv(self.n_seqs, seq_chunk) * seq_chunk
            s_pad = self.plan.s_pad
            dev = self.device
            with span("upload.pack"):
                if sm is not None:   # no second transpose
                    codes_host = np.ascontiguousarray(sm.codes)
                else:
                    codes_host = pad_alignment_site_major(alignment, tile,
                                                          seq_chunk)
            with span("upload.copy", bytes=codes_host.nbytes):
                codes_dev = torch.from_numpy(codes_host).to(dev)
            del codes_host
            if self.site_perm is not None:
                with span("upload.planes"):
                    rows = np.concatenate([self.site_perm,
                                           np.arange(self.n_sites, s_pad)])
                    codes_dev = codes_dev.index_select(
                        0, torch.from_numpy(rows).to(dev))
            if weights is None:
                with span("upload.weights"):
                    weights = henikoff_weights_site_major(
                        codes_dev, self.n_seqs)[:self.n_seqs].cpu().numpy()
            with span("upload.pack"):
                w_arr = np.asarray(weights, dtype=np.float32)
                exact = weights_bf16_exact(w_arr)
                unit = bool((w_arr == 1.0).all())
                if exact or unit:
                    wquant = ""
                elif cfg.weight_quant == "none":
                    wquant = "int8x3"
                elif cfg.weight_quant == "split_bf16":
                    wquant = ""
                else:
                    wquant = cfg.weight_quant
                nlev = {"int8": 2, "int8x3": 3}.get(wquant, 0)
                if nlev:
                    weights_host = pad_weights_int8(w_arr, seq_chunk,
                                                    levels=nlev)
                elif wquant == "lo_int8":
                    weights_host = pad_weights_lo_int8(w_arr, seq_chunk)
                else:
                    weights_host = pad_weights(w_arr, seq_chunk)
            # Preplaned factorized planes: the JAX session never preplanes a
            # hybrid phase 0 (driver.py:709), but both factorized entries
            # give the same bits, so phase 0 takes the planes whenever they
            # fit, as a pure factorized session does.  The general kernel's
            # one-hot planes only under "on": JAX never selects them
            # (measured neutral on the TPU, pallas_ld.py:40-41), and the
            # codes are read anyway.
            mm_bytes = (1 + nlev) * 2 * s_pad * n_pad
            self._preplaned = "majmin" in kernels and (
                cfg.preplaned == "on" or (
                    cfg.preplaned == "auto" and auto_preplaned(
                        seq_chunk, mm_bytes, plane_budget(self.device))))
            self.general_preplaned = ("general" in kernels
                                      and cfg.preplaned == "on")
            # Keyword arguments of every factorized kernel call of this
            # session; the general kernel adds its planes.
            self.kernel_kw = dict(tile=tile, n_sites=self.n_sites,
                                  seq_chunk=seq_chunk, exact_weights=exact,
                                  unit_weights=unit, wquant=wquant)
            self.general_kw = dict(self.kernel_kw, planes=self.planes,
                                   preplaned=self.general_preplaned)
            self.weights = w_arr
            with span("upload.copy", bytes=weights_host.nbytes):
                self.weights_dev = torch.from_numpy(weights_host).to(dev)
            self.auxc_dev = None
            if "majmin" in kernels:
                with span("upload.scan"):
                    if site_counts is None:   # no packing: the input's order
                        site_counts = self._host_counts()
                    auxc, _auxr = majmin_site_aux(None, s_pad,
                                                  counts=site_counts)
                with span("upload.copy", bytes=auxc.nbytes):
                    self.auxc_dev = torch.from_numpy(auxc).to(dev)
            self.planes_dev = self.xq_dev = self.gplanes_dev = None
            with span("upload.planes"):
                if self._preplaned:
                    self.planes_dev = build_majmin_planes(
                        codes_dev, self.auxc_dev, tile=tile)
                    if nlev:
                        self.xq_dev = build_majmin_xq(self.planes_dev,
                                                      self.weights_dev, nlev)
                if self.general_preplaned:
                    self.gplanes_dev = build_planes_tiled(
                        codes_dev, tile=tile, planes=self.planes)
            needs_codes = (("majmin" in kernels and not self._preplaned)
                           or ("general" in kernels
                               and not self.general_preplaned))
            self.codes_dev = codes_dev if needs_codes else None
            del codes_dev
            # Every operand a batch reads, once per distinct shard device.
            with span("upload.copy"):
                self._ops = [dict(zip(("codes", "weights", "auxc", "planes",
                                       "xq", "gplanes", "orig"), ops))
                             for ops in replicate(
                                 self.devices, self.codes_dev,
                                 self.weights_dev, self.auxc_dev,
                                 self.planes_dev, self.xq_dev,
                                 self.gplanes_dev, self._orig_dev)]

        # Each phase's tile pairs striped over the G shards on its own
        # (driver.py:852-877), each shard's share padded to whole batches
        # with non-emitting tiles, and uploaded once; batches are addressed
        # by slice.  The general phase of a hybrid plan is usually small:
        # its batches are no larger than a shard's share of it (JAX buckets
        # that size in powers of 4 to bound its compiled shapes; nothing is
        # compiled per shape here).
        g = self.n_shards
        first = process_index() * self.n_local
        self._phases = []
        for kern, sel in parts:
            with span("upload.plan") as sp:
                sub = replace(self.plan, tile_i=self.plan.tile_i[sel],
                              tile_j=self.plan.tile_j[sel])
                ti_s, tj_s, em_s = stripe(sub, g)
                per = len(ti_s) // g
                k_p = k if len(parts) == 1 or kern == "majmin" \
                    else max(1, min(k, per))
                nb = cdiv(per, k_p)
                ti = np.zeros((g, nb * k_p), np.int32)
                tj = np.zeros((g, nb * k_p), np.int32)
                em = np.zeros((g, nb * k_p), np.int32)
                ti[:, :per] = ti_s.reshape(g, per)
                tj[:, :per] = tj_s.reshape(g, per)
                em[:, :per] = em_s.reshape(g, per)
                if sp:
                    sp.set(tile_pairs=sub.n_tiles, batches=nb)
            with span("upload.copy", bytes=3 * ti[0].nbytes * self.n_local):
                local = [(torch.from_numpy(ti[first + s]).to(d),
                          torch.from_numpy(tj[first + s]).to(d),
                          torch.from_numpy(em[first + s]).to(d))
                         for s, d in enumerate(self.devices)]
            self._phases.append(_Phase(
                kernel=kern, n_tiles=sub.n_tiles, k=k_p, n_batches=nb,
                tile_i_host=ti, tile_j_host=tj, emit_host=em,
                tile_i=[x[0] for x in local],
                tile_j=[x[1] for x in local], emit=[x[2] for x in local]))
        self.n_batches = sum(ph.n_batches for ph in self._phases)
        # The speculative capacity (driver.py:570-572): per batch, the
        # last-seen record count of each local shard under the threshold
        # ``_caps_thr``; for batches not seen, the two-batch window's.
        self._batch_caps: dict[int, list[int]] = {}
        self._caps_thr = None
        self._cap_hist: list[int] = []
        self._spec_cap = 0
        # Local shard slices read by each compaction path, every scan's.
        self.path_counts = {"speculative": 0, "exact": 0}
        with span("upload.sync"):
            for d in {str(d): d for d in self.devices}.values():
                if d.type == "cuda":
                    torch.cuda.synchronize(d)  # set-up ends with its work

    def _upload_xla(self, alignment: np.ndarray, weights) -> None:
        """The XLA engine's operands (``driver.py:785-806``): the
        sequence-major codes padded with UNKNOWN sites (:func:`pad_alignment`)
        and float32 weights, once per distinct shard device.
        ``weights=None`` computes the Henikoff weights on the device from
        the uploaded codes (``henikoff_weights``, as JAX ``:792-795``).  No
        packing, aux, planes or weight quantization."""
        tile = self.cfg.tile
        codes_dev = torch.from_numpy(np.ascontiguousarray(
            pad_alignment(alignment, tile), dtype=np.int8)).to(self.device)
        if weights is None:
            weights = henikoff_weights(
                codes_dev[:, :self.n_sites]).cpu().numpy()
        self.weights = np.asarray(weights, dtype=np.float32)
        self.weights_dev = torch.from_numpy(self.weights).to(self.device)
        self.codes_dev = codes_dev
        self.auxc_dev = self.planes_dev = self.xq_dev = self.gplanes_dev = None
        self._preplaned = self.general_preplaned = False
        self.kernel_kw = dict(tile=tile, n_sites=self.n_sites)
        self.general_kw = None
        self._ops = [dict(codes=c, weights=w, orig=None) for c, w
                     in replicate(self.devices, codes_dev, self.weights_dev)]

    @staticmethod
    def required_padding(n_seqs: int, n_sites: int,
                         cfg: DriverConfig | None = None,
                         majmin: bool = False) -> tuple[int, int]:
        """``(s_pad, n_pad)`` a :class:`SiteMajorCodes` buffer must have to
        feed a session built with ``cfg``: the constructor's tile and seq
        chunk resolution (``driver.py:889-918``; one tile rule), so a
        streaming reader can allocate the padded buffer before it decodes.
        ``majmin`` is accepted and not consulted, as in
        :func:`resolve_tile` (no N band).  Such a buffer feeds the pallas
        engine only: ``engine="xla"`` raises ``ValueError``, as in JAX."""
        del majmin
        cfg = cfg or DriverConfig()
        engine = _resolve_engine(cfg.engine)
        if engine != "pallas":
            raise ValueError(
                f"SiteMajorCodes input requires the pallas engine, got "
                f"{engine!r}")
        tile = resolve_tile(cfg.tile)
        seq_chunk = resolve_seq_chunk(cfg.seq_chunk, n_seqs)
        return (cdiv(n_sites, tile) * tile,
                cdiv(n_seqs, seq_chunk) * seq_chunk)

    def _host_counts(self) -> np.ndarray:
        """``[S, 5]`` per-site allele counts of the host input, in the
        caller's site order."""
        if isinstance(self._host, SiteMajorCodes):
            return site_histogram_host_site_major(
                self._host.codes, self.n_sites, self.n_seqs)
        return site_histogram_host(self._host)

    @property
    def preplaned(self) -> bool:
        """Whether the factorized kernel runs its preplaned entry point."""
        return self._preplaned

    @property
    def operands(self) -> tuple[torch.Tensor, ...]:
        """The factorized kernel's leading arguments: ``(planes, xq)`` for
        the preplaned entry, ``(codes,)`` for the codes entry."""
        if self._preplaned:
            return self.planes_dev, self.xq_dev
        return (self.codes_dev,)

    @property
    def phase_tiles(self) -> dict[str, int]:
        """Real tile pairs per kernel: ``{"majmin": n, "general": m}``, and
        ``"xla"``, all of them, for an XLA-engine session."""
        out = {"majmin": 0, "general": 0}
        for ph in self._phases:
            out[ph.kernel] = out.get(ph.kernel, 0) + ph.n_tiles
        return out

    def _locate(self, b: int) -> tuple[_Phase, int]:
        for ph in self._phases:
            if b < ph.n_batches:
                return ph, b
            b -= ph.n_batches
        raise IndexError(f"batch {b} out of range")

    def batch_tiles(self, b: int, shard: int = 0) -> tuple[torch.Tensor, ...]:
        """``(tile_i, tile_j, emit)`` of local shard ``shard``'s slice of
        batch ``b``, on its device."""
        ph, lb = self._locate(b)
        sl = slice(lb * ph.k, (lb + 1) * ph.k)
        return ph.tile_i[shard][sl], ph.tile_j[shard][sl], ph.emit[shard][sl]

    def batch_tiles_host(self, b: int, shard: int = 0,
                         ) -> tuple[np.ndarray, ...]:
        """The host copy of :meth:`batch_tiles` (``_batch_tiles_host``,
        ``driver.py:1529-1541``): ``(tile_i, tile_j, emit)`` numpy."""
        ph, lb = self._locate(b)
        g = process_index() * self.n_local + shard
        sl = slice(lb * ph.k, (lb + 1) * ph.k)
        return (ph.tile_i_host[g, sl], ph.tile_j_host[g, sl],
                ph.emit_host[g, sl])

    def batch_kernel(self, b: int, shard: int = 0):
        """``(wrapper, plain version, leading arguments, keywords)`` of the
        kernel that runs batch ``b`` on local shard ``shard``:
        ``wrapper(*args, tile_i, tile_j, emit, **kw)`` computes its
        stats.  Under the XLA engine both are
        :func:`~weightedld_tpu_torch.core.ld_tiled.tile_stats_batch`, with
        ``(codes, weights)`` and ``{tile, n_sites}``."""
        ph, _lb = self._locate(b)
        op = self._ops[shard]
        if ph.kernel == "xla":
            return (tile_stats_batch, tile_stats_batch,
                    (op["codes"], op["weights"]), self.kernel_kw)
        if ph.kernel == "general":
            src = op["gplanes"] if self.general_preplaned else op["codes"]
            return (tile_stats_general, tile_stats_general_plain,
                    (src, op["weights"]), self.general_kw)
        if self._preplaned:
            fn, plain = tile_stats_majmin_pre, tile_stats_majmin_pre_plain
            lead = (op["planes"], op["xq"])
        else:
            fn, plain = tile_stats_majmin, tile_stats_majmin_plain
            lead = (op["codes"],)
        return fn, plain, (*lead, op["weights"], op["auxc"]), self.kernel_kw

    def _dispatch(self, b: int, shard: int = 0):
        """Run local shard ``shard``'s slice of batch ``b``: ``(PairStats
        [K, T, T], tile_i, tile_j)``, the window and cross masks folded
        into ``keep``."""
        ti, tj, em = self.batch_tiles(b, shard)
        fn, _plain, args, kw = self.batch_kernel(b, shard)
        with span("batch.kernel", device=self.devices[shard]) as sp:
            st = fn(*args, ti, tj, em, **kw)
        if sp:
            tiles = int(self.batch_tiles_host(b, shard)[2].sum())
            sp.set(tile_pairs=tiles, pairs=tiles * self.cfg.tile ** 2)
        self._mask_pairs(st.keep, ti, tj, shard)
        return st, ti, tj

    def _launch_shards(self, b: int, reduce) -> list:
        """``[reduce(stats, tile_i, tile_j, shard)]`` of every local
        shard's slice of batch ``b``, in shard order: each shard's kernel
        and the device ops of its reduction are launched before the caller
        reads any result back (:func:`_to_host`), so slices on different
        cards run at once.  ``reduce`` must not read the device."""
        out = []
        for sh in range(self.n_local):
            st, ti, tj = self._dispatch(b, sh)
            with span("batch.reduce", device=self.devices[sh]):
                out.append(reduce(st, ti, tj, sh))
        return out

    def _pipelined(self, launch, start: int = 0) -> Iterator[tuple]:
        """``(b, launch(b))`` for every batch from ``start``, each yielded
        once batch b + 1 is launched (``_pipelined``, ``driver.py:1223-
        1246``): the host reads batch b while the device computes b + 1.
        A caller drops its reference to batch b before it asks for the
        next, so at most two launched batches are alive; a batch launched
        but never yielded (the caller stopped) is dropped unread."""
        pending = None
        for b in range(start, self.n_batches):
            nxt = (b, launch(b))
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def _pipelined_reduce(self, reduce) -> Iterator[list]:
        """Every batch's ``reduce`` (a small device tensor per local shard,
        :meth:`_launch_shards`) as host arrays in shard order, read one
        batch behind compute (``_pipelined_reduce``, ``driver.py:1290-
        1310``): each result's copy to the host starts at launch."""
        for _b, copies in self._pipelined(lambda b: self._launch_shards(
                b, lambda *a: _start_copy(reduce(*a)))):
            yield [_to_host(c)[0] for c in copies]

    def _mask_pairs(self, keep: torch.Tensor, ti: torch.Tensor,
                    tj: torch.Tensor, shard: int = 0) -> None:
        """Fold the in-tile remainder of the window and cross plans into
        ``keep`` in place (``parallel/sharded.py:155-194``): the site-index
        window ``gj - gi <= W`` (``|orig[b] - orig[a]| <= W`` when
        windowed-packed), the bp window ``pb - pa <= W`` (``|pb - pa|``
        when windowed-packed) and the rectangle ``gi < split <= gj``.  Each
        is a broadcast comparison of ``[K, T]`` vectors that yields the
        ``[K, T, T]`` bool directly, with no integer ``[K, T, T]``
        intermediate.  The masks' device work is a ``batch.reduce`` span of
        its own, beside the one of :meth:`_launch_shards`."""
        cfg = self.cfg
        if (cfg.max_site_distance is None and cfg.max_bp_distance is None
                and cfg.cross_split is None):
            return
        with span("batch.reduce", device=keep.device):
            t = cfg.tile
            li = torch.arange(t, device=keep.device, dtype=torch.int64)
            gi = ti.to(torch.int64)[:, None] * t + li          # [K, T] rows
            gj = tj.to(torch.int64)[:, None] * t + li          # [K, T] cols
            both = self.windowed_packed
            if cfg.max_site_distance is not None:
                orig = self._ops[shard]["orig"]
                if orig is not None:
                    a, b = orig[gi], orig[gj]
                else:
                    a, b = gi, gj
                _fold_within(keep, a, b, cfg.max_site_distance, both)
            if cfg.max_bp_distance is not None:
                sm = self._sm_reps[shard]
                _fold_within(keep, sm[gi].to(torch.int64),
                             sm[gj].to(torch.int64), cfg.max_bp_distance,
                             both)
            if cfg.cross_split is not None:
                split = cfg.cross_split
                keep &= (gi < split)[:, :, None] & (gj >= split)[:, None, :]

    def _threshold(self, r2_threshold) -> float:
        thr = self.cfg.r2_threshold if r2_threshold is _UNSET \
            else r2_threshold
        return -np.inf if thr is None else float(thr)

    @spanned("query.summarize")
    def summarize(self, r2_threshold=_UNSET) -> dict:
        """Whole-triangle reduction: surviving pair count, count over the
        threshold, and r2 sum over threshold / max, with no records
        (``driver.py:1312-1342``; moments as ``sharded.py:195-218``).  The
        four moments of a batch are one float64 tensor (counts exact, the
        float32 sum and max widened exactly) read with one host copy; each
        shard adds its batches up, and the shards' totals are merged once
        at the end, in shard order."""
        thr = self._threshold(r2_threshold)
        f64 = torch.float64

        def moments(st, _ti, _tj, _sh):
            mask = threshold_mask(st, thr)
            zero = torch.zeros((), dtype=st.r2.dtype, device=st.r2.device)
            return torch.stack([
                st.keep.sum().to(f64), mask.sum().to(f64),
                torch.where(mask, st.r2, zero).sum().to(f64),
                torch.where(st.keep, st.r2, zero - torch.inf).max().to(f64),
            ])

        acc = [np.array([0.0, 0.0, 0.0, -np.inf]) for _ in self.devices]
        for moms in self._pipelined_reduce(moments):
            for tot, mom in zip(acc, moms):
                tot[:3] += mom[:3]
                tot[3] = max(tot[3], mom[3])
        n_pairs, n_over, r2_sum, r2_max = merge_moments(gather_shards(acc))
        return {
            "n_sequences": self.n_seqs,
            "n_sites": self.n_sites,
            "n_pairs": n_pairs,
            "n_over_threshold": n_over,
            "r2_sum_over_threshold": r2_sum,
            "r2_max": r2_max if n_pairs else None,
        }

    def _fold(self, sites: np.ndarray) -> np.ndarray:
        """Internal ``[n, 2]`` site pairs -> endpoints in the caller's site
        order (``driver.py:1180-1190``): under packing internal i < j no
        longer implies original order, so swap the endpoints back to the
        reference's (earlier site, later site); D, D' and r2 are symmetric
        under the swap."""
        if self.site_perm is None or not len(sites):
            return sites
        oi = self.site_perm[sites[:, 0]]
        oj = self.site_perm[sites[:, 1]]
        flip = oi > oj
        return np.stack([np.where(flip, sites[:, 1], sites[:, 0]),
                         np.where(flip, sites[:, 0], sites[:, 1])], axis=1)

    def batch_emit_tiles(self, b: int) -> int:
        """Real (emitting) tile pairs of batch ``b``, every shard's."""
        ph, lb = self._locate(b)
        return int(ph.emit_host[:, lb * ph.k:(lb + 1) * ph.k].sum())

    @spanned("query.stream")
    def stream(self, start_batch: int = 0, r2_threshold=_UNSET,
               on_progress: Callable[[Progress], None] | None = None,
               decimals: int | None = None,
               ) -> Iterator[tuple[int, LdRecords]]:
        """Yield ``(batch_index, records)`` batch by batch
        (``driver.py:1643-1729``).  ``r2_threshold`` overrides the
        session's threshold for this scan only.  ``on_progress`` receives a
        :class:`Progress` after a batch is read when ``cfg.progress_every_s``
        has passed since the last report, and after the last batch
        (``driver.py:1680-1700``): the pairs of this scan's emitted tiles,
        every shard's and both phases of a hybrid plan, against the whole
        plan's.  Each batch's records are every shard's, in global shard
        order on every process (:func:`parallel.sharded.gather_records`).

        ``decimals=None`` yields exact float32 values.  ``decimals`` in
        0..4 (the caller writes ``decimals``-digit text, as ``run_to_tsv``
        does) yields D and r2 rounded on the device to ``decimals`` as
        CPython's ``round`` rounds them, on every path and plan, D' exact:
        the formatted output is byte for byte the default's.  (The JAX
        session ships such records in a 12-byte fixed-point wire and yields
        exact values where the wire cannot address the plan, T > 512.)
        Any other value raises ``ValueError``.

        Batch b + 1 is launched before batch b is read
        (:meth:`_pipelined`); a batch's compaction runs at the capacity
        learned for it (:meth:`_batch_capacity`), so a re-scan reads
        nothing back between launches.  Stopping the iteration drops the
        batch launched ahead unread."""
        scale = self._decimals_scale(decimals)
        thr = self._threshold(r2_threshold)
        self._caps_for(thr)
        t = self.cfg.tile
        t0 = last_report = time.monotonic()
        tiles_done = records_emitted = 0
        for b, launched in self._pipelined(
                lambda b: self._launch_records(b, thr, scale), start_batch):
            rec = self._read_records(b, launched, scale)
            del launched    # this batch's stats go before b + 2 launches
            records_emitted += len(rec)
            tiles_done += self.batch_emit_tiles(b)
            now = time.monotonic()
            if on_progress and (now - last_report > self.cfg.progress_every_s
                                or b == self.n_batches - 1):
                on_progress(Progress(pairs_done=tiles_done * t * t,
                                     pairs_total=self.plan.n_tiles * t * t,
                                     records_emitted=records_emitted,
                                     elapsed_s=now - t0))
                last_report = now
            yield b, rec

    def _decimals_scale(self, decimals: int | None) -> int | None:
        """``10^decimals``, or None for ``decimals=None``; decimals outside
        0..4 raise (``driver.py:965-984``)."""
        if decimals is None:
            return None
        if not 0 <= int(decimals) <= 4:
            raise ValueError(
                f"decimals must be in 0..4 (text-output precision), got "
                f"{decimals!r}")
        return 10 ** int(decimals)

    def _caps_for(self, thr: float) -> None:
        """Forget the per-batch capacities when the threshold changes:
        record counts depend on it (``driver.py:1706-1711``)."""
        if self._caps_thr != thr:
            self._batch_caps = {}
            self._caps_thr = thr

    def _batch_capacity(self, b: int, shard: int) -> int | None:
        """Speculative capacity of local shard ``shard``'s slice of batch
        ``b`` (``driver.py:1248-1288``), None for the exact path: the
        slice's last-seen count (record counts are deterministic per input
        and threshold) plus 1/8 and at least 256, else the two-batch
        window's.  The port compiles nothing per shape, so it keeps no
        grid of capacities."""
        known = self._batch_caps.get(b)
        if known is None:
            return self._spec_cap or None
        cap = _spec_capacity(known[shard])
        if cap > _SPEC_CAP_MAX:
            return self._spec_cap or None
        return cap

    def _learn(self, b: int, counts: list[int]) -> None:
        """Remember batch ``b``'s per-shard counts and slide the two-batch
        window (``driver.py:1070-1092``): capacity shrinks again after two
        batches of a lower yield, and a batch beyond ``_SPEC_CAP_MAX``
        turns speculation off for unseen batches."""
        self._batch_caps[b] = counts
        top = max(counts)
        cap = _spec_capacity(top)
        if cap <= _SPEC_CAP_MAX:
            self._cap_hist = (self._cap_hist + [cap])[-2:]
            self._spec_cap = max(self._cap_hist)
        elif top:
            self._cap_hist = []
            self._spec_cap = 0

    def _launch_records(self, b: int, thr: float, scale: int | None) -> list:
        """Launch batch ``b``'s records on every local shard: the kernel,
        the masks and the threshold, and where the slice has a capacity
        the speculative compaction (:func:`compact_fixed`, D and r2
        rounded at ``scale``) with its count and block on their way to the
        host.  Per shard ``(stats, tile_i,
        tile_j, mask, capacity, copy)``; ``capacity`` and ``copy`` are
        None for the exact path."""
        t = self.cfg.tile

        def compact(st, ti, tj, sh):
            mask = threshold_mask(st, thr)
            cap = self._batch_capacity(b, sh)
            copy = None
            if cap is not None:
                copy = _start_copy(*compact_fixed(
                    st, ti, tj, mask, tile=t, capacity=cap, scale=scale))
            return st, ti, tj, mask, cap, copy

        return self._launch_shards(b, compact)

    def _read_records(self, b: int, launched: list,
                      scale: int | None) -> LdRecords:
        """Batch ``b``'s records from :meth:`_launch_records`, every
        shard's, merged in global shard order on every process: a slice
        whose count fits its capacity decodes its block, any other gathers
        exactly from the stats kept alive for it, D and r2 rounded on the
        device at ``scale`` as the block's were."""
        t = self.cfg.tile
        local, counts = [], []
        for sh, (st, ti, tj, mask, cap, copy) in enumerate(launched):
            with span("batch.read", capacity=cap) as sp:
                n = None
                if copy is not None:
                    count, block = _to_host(copy)
                    n = int(count)
                if n is not None and n <= cap:
                    self.path_counts["speculative"] += 1
                    if sp:
                        sp.set(path="speculative")
                    sites, vals = decode_block(block[:n])
                else:
                    self.path_counts["exact"] += 1
                    if sp:
                        sp.set(path="exact")
                    n, sites, vals = compact_tile_stats(
                        st, ti, tj, mask, tile=t, scale=scale)
                    sites, vals = sites.cpu().numpy(), vals.cpu().numpy()
                if sp:
                    sp.set(records=int(n))
            counts.append(n)
            local.append((sites, vals))
        self._learn(b, counts)
        with span("batch.gather") as sp:
            sites_h, vals_h = gather_records(local)
            sites_h = self._fold(sites_h)
            if sp:
                sp.set(records=len(sites_h))
            return LdRecords(
                pos_a=self.site_map[sites_h[:, 0]],
                pos_b=self.site_map[sites_h[:, 1]],
                d=vals_h[:, 0], d_prime=vals_h[:, 1], r2=vals_h[:, 2])

    def run_batch(self, b: int) -> LdRecords:
        """Batch ``b``'s records over the session's threshold, every
        shard's, in global shard order on every process: what
        :meth:`stream` yields for batch ``b`` (``driver.py:1205-1207``)."""
        if not 0 <= b < self.n_batches:
            raise IndexError(f"batch {b} out of range")
        thr = self._threshold(_UNSET)
        self._caps_for(thr)
        return self._read_records(b, self._launch_records(b, thr, None),
                                  None)

    # -- analytics (driver.py:1344-1641) ------------------------------------

    def _in_input_order(self, x: np.ndarray) -> np.ndarray:
        """Per-site values in the session's (packed) site order -> the
        caller's input order."""
        if self.site_perm is None:
            return x
        out = np.empty_like(x)
        out[self.site_perm] = x
        return out

    def _site_map_dev(self, what: str) -> torch.Tensor:
        """The site map as a padded ``[S_pad]`` int32 device tensor, one
        validated copy for the bp-window mask and :meth:`ld_decay` (copy of
        ``_ensure_sm_dev``, ``driver.py:920-951``): int32 range, and
        non-decreasing in the caller's input order (``_sm_orig_nondecr``
        under packing: the packed map is non-monotonic by design, and
        per-pair |distance| is order-free)."""
        if self._sm_dev is not None:
            return self._sm_dev
        sm = self.site_map
        if sm.size and (sm.max() > np.iinfo(np.int32).max or sm.min() < 0):
            raise ValueError(f"{what} needs site_map positions that fit "
                             "int32 (the device distance dtype)")
        nondecr = (self._sm_orig_nondecr if self.site_perm is not None
                   else not bool((np.diff(sm) < 0).any()))
        if not nondecr:
            raise ValueError(
                f"{what} needs a non-decreasing site_map (positions "
                "restart mid-file — multi-chromosome input? run per "
                "chromosome)")
        sm_pad = np.zeros(cdiv(self.n_sites, self.cfg.tile) * self.cfg.tile,
                          dtype=np.int32)
        sm_pad[:self.n_sites] = sm      # padding sites have keep == False
        self._sm_dev = torch.from_numpy(sm_pad).to(self.device)
        self._sm_reps = [t for (t,) in replicate(self.devices, self._sm_dev)]
        return self._sm_dev

    @spanned("query.ld_decay")
    def ld_decay(self, edges) -> dict:
        """LD-decay curve (``driver.py:1344-1389``): per distance bin
        ``edges[b] <= dist < edges[b+1]`` in ``site_map`` units (bp for a
        VCF), the kept-pair count, r2 sum and mean, and the |D'| sum and
        mean over the pairs whose D' is finite (``n_d_prime_finite``).  The
        session's r2 threshold is ignored."""
        edges = validate_decay_edges(edges)
        self._site_map_dev("ld_decay")
        nb = len(edges) - 1
        acc = [np.zeros((nb, 4), dtype=np.float64) for _ in self.devices]
        for sums in self._pipelined_reduce(
                lambda st, ti, tj, sh: decay_batch(
                    st, ti, tj, self._sm_reps[sh], edges,
                    tile=self.cfg.tile)):
            for tot, part in zip(acc, sums):
                tot += part
        tot = merge_sums(gather_shards(acc))
        counts = tot[:, 0].astype(np.int64)
        dp_counts = tot[:, 3].astype(np.int64)
        sums, dp_sums = tot[:, 1], tot[:, 2]
        return {
            "edges": list(edges),
            "n_pairs": counts.tolist(),
            "r2_sum": sums.tolist(),
            "r2_mean": [float(s / c) if c else None
                        for s, c in zip(sums, counts)],
            "abs_d_prime_sum": dp_sums.tolist(),
            "abs_d_prime_mean": [float(s / c) if c else None
                                 for s, c in zip(dp_sums, dp_counts)],
            "n_d_prime_finite": dp_counts.tolist(),
        }

    @spanned("query.r2_histogram")
    def r2_histogram(self, edges) -> dict:
        """Histogram of r2 over all surviving pairs, bin ``edges[b] <= r2 <
        edges[b+1]`` (``driver.py:1391-1405``); the session's r2 threshold
        is ignored."""
        edges = validate_hist_edges(edges)
        acc = [np.zeros(len(edges) - 1, dtype=np.int64) for _ in self.devices]
        dev_edges = [torch.tensor(edges, dtype=torch.float32, device=d)
                     for d in self.devices]
        for parts in self._pipelined_reduce(
                lambda st, _ti, _tj, sh: hist_batch(st, dev_edges[sh])):
            for counts, part in zip(acc, parts):
                counts += part
        counts = merge_sums(gather_shards(acc))
        return {"edges": list(edges), "n_pairs": counts.tolist()}

    @spanned("query.top_pairs")
    def top_pairs(self, k: int) -> LdRecords:
        """The ``k`` strongest surviving pairs by r2, descending, over the
        whole triangle (``driver.py:1488-1527``): each shard's slice of a
        batch selects its own top ``k`` on the device, the host merges
        (batch-major, then shard order).  The session's r2 threshold is
        ignored; ties at the k-th value are broken arbitrarily."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        local = []
        for parts in self._pipelined_reduce(
                lambda st, ti, tj, _sh: topk_batch(
                    st, ti, tj, tile=self.cfg.tile, k=k)):
            for rows in parts:
                local.append(rows[rows[:, 4] > -np.inf])   # unkept slots
        per_proc = allgather(local)
        cand = merge_topk([per_proc[p][b * self.n_local + sh]
                           for b in range(self.n_batches)
                           for p in range(self.n_procs)
                           for sh in range(self.n_local)], k)
        sites = self._fold(cand[:, :2].astype(np.int64))
        return LdRecords(
            pos_a=self.site_map[sites[:, 0]],
            pos_b=self.site_map[sites[:, 1]],
            d=cand[:, 2].astype(np.float32),
            d_prime=cand[:, 3].astype(np.float32),
            r2=cand[:, 4].astype(np.float32))

    def _maf(self) -> np.ndarray:
        """Per-site minor-allele fraction in the session's site order (the
        reference's all-minor definition, ``WeightedLD.py:79-87``; copy of
        ``driver.py:1465-1486``), computed once from the host input (its
        site-major buffer for a streamed session), which is released
        afterwards."""
        if self._maf_cache is None:
            counts = self._host_counts()                            # [S, 5]
            if self.site_perm is not None:
                counts = counts[self.site_perm]
            major = counts.max(axis=1)
            total = counts.sum(axis=1)
            self._maf_cache = (total - major) / np.maximum(total, 1)
            self._host = None
        return self._maf_cache

    @spanned("query.prune")
    def prune(self, r2_threshold: float, rule: str = "maf",
              on_progress: Callable[[Progress], None] | None = None,
              ) -> np.ndarray:
        """Greedy LD pruning, the PLINK ``--indep-pairwise`` idea
        (``driver.py:1407-1463``): the ``site_map`` positions, in input
        order, of a subset of sites in which no surviving pair has ``r2 >
        r2_threshold``.  The pairs above the threshold are swept in
        (pos_a, pos_b) order on the host; where both endpoints are still
        kept, ``rule="maf"`` drops the one with the lower minor-allele
        fraction (ties: the later site) and ``rule="first"`` the later
        one."""
        if rule not in ("maf", "first"):
            raise ValueError(f"rule must be maf|first, got {rule!r}")
        if not np.isfinite(r2_threshold):
            raise ValueError(
                f"r2_threshold must be finite, got {r2_threshold!r}")
        pos_to_idx = {int(p): i for i, p in enumerate(self.site_map)}
        if len(pos_to_idx) != self.n_sites:
            raise ValueError("prune needs unique site_map positions "
                             "(multi-chromosome input? run per chromosome)")
        pa_parts, pb_parts = [], []
        for _b, rec in self.stream(r2_threshold=float(r2_threshold),
                                   on_progress=on_progress):
            pa_parts.append(np.asarray(rec.pos_a))
            pb_parts.append(np.asarray(rec.pos_b))
        with span("prune.sweep") as sp:
            maf = self._maf() if rule == "maf" else None
            kept = np.ones(self.n_sites, dtype=bool)
            if pa_parts:
                pa = np.concatenate(pa_parts)
                pb = np.concatenate(pb_parts)
                order = np.lexsort((pb, pa))
                for qa, qb in zip(pa[order], pb[order]):
                    a, b = pos_to_idx[int(qa)], pos_to_idx[int(qb)]
                    if kept[a] and kept[b]:
                        if rule == "maf" and maf[a] < maf[b]:
                            kept[a] = False
                        else:
                            kept[b] = False
                if sp:
                    sp.set(pairs=len(pa))
            # The surviving positions in the caller's input order.
            return self._in_input_order(self.site_map)[
                self._in_input_order(kept)]

    @spanned("query.matrices")
    def matrices(self, dtype=np.float32) -> dict[str, np.ndarray]:
        """Full square matrices (``driver.py:1543-1641``): ``{"d",
        "d_prime", "r2": [S, S] dtype, NaN where the pair was skipped or
        below the diagonal; "keep": [S, S] bool}``, in the caller's site
        order.  Host memory is O(S^2); the r2 threshold is ignored.

        ``dtype``: float32 (the kernels' exact stats) or float16 (cast on
        the device before the copy, half the transfer; within 2^-11
        relative).  The JAX package also offers bfloat16, which numpy holds
        only through ``ml_dtypes``; the port refuses it rather than return
        another dtype (ROADMAP queue 3)."""
        if str(dtype) == "bfloat16":
            raise ValueError(
                "dtype bfloat16 is not offered by weightedld_tpu_torch "
                "(numpy has no bfloat16 without ml_dtypes); use float16 or "
                "float32")
        dt = np.dtype(dtype)
        if dt not in (np.dtype(np.float32), np.dtype(np.float16)):
            raise ValueError(
                f"dtype must be float32 or float16, got {dtype!r}")
        tdt = torch.float32 if dt == np.float32 else torch.float16
        s, t = self.n_sites, self.cfg.tile
        out = {k: np.full((s, s), np.nan, dtype=dt)
               for k in ("d", "d_prime", "r2")}
        keep_m = np.zeros((s, s), dtype=bool)
        blocks = []   # (i0, j0, keep, {key: values}) of tiles with a pair

        def outputs(st, _ti, _tj, _sh):
            # Copied when read, not into pinned buffers at launch: the
            # [K, T, T] outputs are not small (13 B per pair).
            return _Copy((torch.stack([st.d, st.d_prime, st.r2]).to(tdt),
                          st.keep), None, None)

        for b, launched in self._pipelined(
                lambda b: self._launch_shards(b, outputs)):
            for sh, (vals, keep_h) in enumerate(_to_host(c)
                                                for c in launched):
                vals = dict(zip(("d", "d_prime", "r2"), vals))
                bi_h, bj_h, em_h = self.batch_tiles_host(b, sh)
                for kk in np.nonzero(em_h)[0]:   # padding tiles cost nothing
                    i0, j0 = int(bi_h[kk]) * t, int(bj_h[kk]) * t
                    if i0 >= s or j0 >= s:
                        continue
                    h, w = min(t, s - i0), min(t, s - j0)
                    km = keep_h[kk, :h, :w]
                    if km.any():
                        blocks.append((i0, j0, km.copy(),
                                       {key: v[kk, :h, :w].copy()
                                        for key, v in vals.items()}))
            del launched    # this batch's outputs go before b + 2 launches
        for i0, j0, km, vals in gather_shards(blocks):
            h, w = km.shape
            keep_m[i0:i0 + h, j0:j0 + w] |= km
            for key, v in vals.items():
                np.copyto(out[key][i0:i0 + h, j0:j0 + w], v, where=km)
        out["keep"] = keep_m
        if self.site_perm is not None:
            # Packed order -> the caller's order: M[perm[k], perm[l]] =
            # M_int[k, l], then entries below the diagonal fold back into
            # the upper triangle.
            p = self.site_perm
            ix = np.ix_(p, p)
            for key in ("d", "d_prime", "r2"):
                m = np.full_like(out[key], np.nan)
                m[ix] = out[key]
                out[key] = m
            km = np.zeros_like(keep_m)
            km[ix] = keep_m
            low = np.nonzero(np.tril(km, k=-1))
            if low[0].size:
                for key in ("d", "d_prime", "r2"):
                    out[key][low[1], low[0]] = out[key][low]
                    out[key][low] = np.nan
                km[low[1], low[0]] = True
                km[low] = False
            out["keep"] = km
        return out


def _spec_capacity(n: int) -> int:
    """Capacity for a slice expected to hold ``n`` records: 1/8 headroom,
    at least 256 (a zero-record slice still runs the compaction, which
    costs about nothing)."""
    return max(256, n + (n >> 3))


@dataclass(frozen=True)
class _Copy:
    """A batch result on its way to the host: the device tensors ``src``,
    kept alive until the copy is read, and on CUDA the pinned ``host``
    buffers their ``non_blocking`` copies fill and the ``event`` recorded
    after them; ``host=None`` copies when read (a CPU tensor, or results
    too large for pinned buffers)."""

    src: tuple
    host: tuple | None
    event: object


def _start_copy(*tensors: torch.Tensor) -> _Copy:
    """Start the host copies of a shard slice's small results on its
    device's current stream, behind the work that makes them (JAX
    ``_prime``, ``driver.py:1209-1221``).  On the CPU nothing is started
    and no pinned memory is asked for."""
    if not tensors[0].is_cuda:
        return _Copy(tensors, None, None)
    host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                 .copy_(x, non_blocking=True) for x in tensors)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return _Copy(tensors, host, event)


def _to_host(copy: _Copy) -> list[np.ndarray]:
    """The host arrays of a started copy: the point at which a session's
    batch loops wait for the device, one batch behind its launches
    (:meth:`LdSession._pipelined`)."""
    with span("batch.wait") as sp:
        if copy.host is None:
            out = [x.cpu().numpy() for x in copy.src]
        else:
            copy.event.synchronize()
            out = [h.numpy() for h in copy.host]
        if sp:
            sp.set(bytes=sum(a.nbytes for a in out))
    return out


def _fold_within(keep: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 w: int, both: bool) -> None:
    """``keep &= b - a <= w`` over pairs (row a, column b) of ``[K, T]``
    int64 vectors, or ``|b - a| <= w`` with ``both``."""
    w = max(-_MASK_CLAMP, min(int(w), _MASK_CLAMP))
    keep &= b[:, None, :] <= (a + w)[:, :, None]
    if both:
        keep &= a[:, :, None] <= (b + w)[:, None, :]


def stream_ld_records(alignment: np.ndarray | SiteMajorCodes,
                      weights: np.ndarray | None,
                      site_map: np.ndarray, cfg: DriverConfig | None = None,
                      device: str | torch.device | None = None,
                      start_batch: int = 0,
                      on_progress: Callable[[Progress], None] | None = None,
                      devices=None, decimals: int | None = None,
                      ) -> Iterator[tuple[int, LdRecords]]:
    """Yield ``(batch_idx, records)`` for every tile batch of the triangle
    (one-shot wrapper over :class:`LdSession`; ``decimals`` as in
    :meth:`LdSession.stream`)."""
    session = LdSession(alignment, weights, site_map, cfg, device, devices)
    yield from session.stream(start_batch=start_batch,
                              on_progress=on_progress, decimals=decimals)


def collect_ld_records(alignment: np.ndarray | SiteMajorCodes,
                       weights: np.ndarray | None,
                       site_map: np.ndarray,
                       cfg: DriverConfig | None = None,
                       device: str | torch.device | None = None,
                       devices=None) -> LdRecords:
    """Run the whole triangle and concatenate every record, in stream order
    (the ``--sort`` path, small and medium S)."""
    parts = [r for _, r in stream_ld_records(alignment, weights, site_map,
                                             cfg, device, devices=devices)]
    if not parts:
        return LdRecords(*(np.empty(0) for _ in range(5)))
    return LdRecords(*(np.concatenate([getattr(p, f) for p in parts])
                       for f in LdRecords._fields))


def _plan_engine(session: LdSession) -> str:
    """The kernels a session's plan runs: ``majmin`` (factorized over the
    whole plan), ``hybrid`` (factorized, then general) or ``general``; or
    ``xla``, the XLA tile engine."""
    if session.engine == "xla":
        return "xla"
    tiles = session.phase_tiles
    if tiles["general"] == 0:
        return "majmin"
    return "hybrid" if tiles["majmin"] else "general"


def run_to_tsv(alignment: np.ndarray | SiteMajorCodes,
               weights: np.ndarray | None,
               site_map: np.ndarray, out_path: str | Path,
               cfg: DriverConfig | None = None,
               device: str | torch.device | None = None,
               checkpoint: bool = True, ndigits: int = 4,
               on_progress: Callable[[Progress], None] | None = None,
               timer=None, annot=None, devices=None) -> int:
    """Stream the triangle into a TSV file (header, then records in stream
    order) with batch-level resume; returns the number of records written.
    ``annot`` (an :class:`io.writer.PairAnnot`) switches rows and header to
    the PLINK layout; ``timer`` collects the ``upload`` and ``scan+write``
    spans.

    With ``checkpoint``, the state file ``<out>.ckpt.json`` records, after
    each batch, the next batch, the byte offset of the flushed output, the
    record count and a fingerprint of the run; a restart skips the
    completed batches and truncates the output to that offset (a torn batch
    is written again).  A ``.gz`` output is then written as one gzip member
    per batch (:class:`io.writer.GzipMemberWriter`), so that the offset is
    a member boundary.  A resumed file equals an uninterrupted checkpointed
    run byte for byte.  A resume whose input or plan differs from the
    checkpoint's is refused with the resolved tile / seq_chunk / batch
    values to pass as explicit flags.  The state file is removed when the
    run ends.

    The fingerprint (``driver.py:1857-1873``) is a sha256 over the whole
    input matrix, the weights, the site map and the resolved plan: the
    global shard count and the process count (a resume under another
    geometry is refused), the weight mode the kernels run
    (``kernel_kw["wquant"]``, with ``weight_quant``), the factorized /
    general tile-pair split (``phase_tiles``) and whether the session
    packed (``site_perm``, ``windowed_packed``), beside the fields both
    packages hash (tile, tiles per batch, seq_chunk, threshold, windows,
    ``cross_split``, shape, ``ndigits`` and the header line).  The engine
    (JAX ``driver.py:1857-1862``) is in the plan's name (``_plan_engine``:
    ``xla``, or the kernels of the pallas engine), so a resume under the
    other ``DriverConfig.engine`` is refused, and the refusal names the
    value to pass.

    Under a process group every process drives its shards and receives
    every record, so all return the same count, but only process 0 opens
    the output and reads or writes the checkpoint (``driver.py:1892-
    1930``); it sends its resume state, or its refusal, to the others."""
    from ..io.writer import (
        GzipMemberWriter,
        open_text_output,
        pair_header,
        write_pairs,
    )
    from .profiling import StageTimer

    header_line = pair_header(annot)
    out_path = Path(out_path)
    is_gz = str(out_path).endswith(".gz")
    ckpt_path = out_path.with_suffix(out_path.suffix + ".ckpt.json")
    timer = timer or StageTimer()
    with timer.stage("upload"):
        session = LdSession(alignment, weights, site_map, cfg, device,
                            devices)
    cfg_r = session.cfg
    tiles = session.phase_tiles
    engine = _plan_engine(session)
    log.info("tiled session: T=%d seq_chunk=%d tiles/batch=%d batches=%d "
             "preplaned=%s factorized tile pairs=%d general tile pairs=%d "
             "packed=%s windowed-packed=%s", cfg_r.tile, cfg_r.seq_chunk,
             cfg_r.tiles_per_shard_batch, session.n_batches,
             session.preplaned, tiles["majmin"], tiles["general"],
             session.site_perm is not None, session.windowed_packed)

    # The fingerprint of the resolved plan and the whole input: batch
    # indices mean something only for one concrete plan.
    aln_arr = (alignment.codes if isinstance(alignment, SiteMajorCodes)
               else np.asarray(alignment))
    h = hashlib.sha256()
    h.update(repr((
        cfg_r.tile, cfg_r.tiles_per_shard_batch, cfg_r.r2_threshold,
        cfg_r.max_site_distance, cfg_r.max_bp_distance, cfg_r.cross_split,
        engine, cfg_r.seq_chunk, cfg_r.weight_quant,
        session.kernel_kw.get("wquant"), tiles["majmin"], tiles["general"],
        session.site_perm is not None, session.windowed_packed,
        (session.n_seqs, session.n_sites), ndigits, header_line,
        session.n_shards, session.n_procs,
    )).encode())
    # The whole matrix in ~16 MB row chunks (sha256 runs at GB/s on the
    # host): a sample would let an edited row resume silently.
    row_bytes = max(1, int(np.prod(aln_arr.shape[1:])) * aln_arr.itemsize)
    step = max(1, (1 << 24) // row_bytes)
    for r0 in range(0, aln_arr.shape[0], step):
        h.update(np.ascontiguousarray(aln_arr[r0:r0 + step]).tobytes())
    h.update(session.weights.tobytes())   # covers weights=None (on device)
    h.update(np.asarray(site_map).tobytes())
    fingerprint = h.hexdigest()
    # The resolved plan, written into the checkpoint so that a refusal can
    # name the explicit flags that reproduce it.
    resolved = {"tile": cfg_r.tile, "seq_chunk": cfg_r.seq_chunk,
                "tiles_per_shard_batch": cfg_r.tiles_per_shard_batch,
                "engine": engine, "weight_quant": cfg_r.weight_quant}

    writer = is_output_process()
    start_batch = 0
    offset = None
    n_written = 0
    refusal = None
    if writer and checkpoint and ckpt_path.exists() and out_path.exists():
        state = json.loads(ckpt_path.read_text())
        if state.get("fingerprint") != fingerprint:
            was = state.get("resolved")
            hint = (
                "; the checkpoint ran with resolved "
                f"tile={was['tile']} seq_chunk={was['seq_chunk']} "
                f"tiles_per_shard_batch={was['tiles_per_shard_batch']} "
                f"engine={was['engine']} — re-run with those as explicit "
                "flags (--tile/--seq-chunk/--tiles-per-batch) to resume it, "
                "or delete the checkpoint to start over"
                if was else "; delete it to start over")
            refusal = (f"{ckpt_path}: checkpoint belongs to a different run "
                       f"(config or input changed){hint}")
            if was and (was["engine"] == "xla") != (engine == "xla"):
                ran = "xla" if was["engine"] == "xla" else "pallas"
                refusal += f" (it ran DriverConfig(engine={ran!r}))"
        else:
            start_batch = state["next_batch"]
            offset = state["byte_offset"]
            n_written = state["n_records"]
            log.info("resuming at batch %d (%d records already written)",
                     start_batch, n_written)
    if session.n_procs > 1:
        # Every process iterates the same batches (each batch's records
        # are gathered), so all take process 0's resume state.
        start_batch, n_written, refusal = broadcast(
            (start_batch, n_written, refusal))
    if refusal is not None:
        raise RuntimeError(refusal)

    if not writer:
        fh = None
    elif is_gz and checkpoint:
        fh = GzipMemberWriter(out_path, append_at=offset)
        if offset is None:
            fh.write(header_line + "\n")
            fh.flush()   # the header is its own member: batch 0 can resume
    elif offset is None:
        fh = open_text_output(out_path)
        fh.write(header_line + "\n")
    else:
        fh = open(out_path, "r+")
        fh.truncate(offset)
        fh.seek(offset)

    t0 = time.monotonic()
    with fh if fh is not None else nullcontext(), \
            timer.stage("scan+write"):
        # Text at <= 4 decimals streams rounded records, byte for byte the
        # same output (driver.py:1952-1958).
        for b, rec in session.stream(
                start_batch=start_batch, on_progress=on_progress,
                decimals=ndigits if 0 <= ndigits <= 4 else None):
            n_written += len(rec)
            if fh is None:
                continue
            write_pairs(rec, fh, ndigits=ndigits, header=False, annot=annot)
            if checkpoint:
                fh.flush()
                ckpt_path.write_text(json.dumps({
                    "next_batch": b + 1,
                    "byte_offset": fh.tell(),
                    "n_records": n_written,
                    "fingerprint": fingerprint,
                    "resolved": resolved,
                }))
    log.info("%d records in %.3fs", n_written, time.monotonic() - t0)
    if writer and ckpt_path.exists():
        ckpt_path.unlink()
    return n_written
