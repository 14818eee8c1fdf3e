"""All-pairs LD driver on one device: batches of triangle tiles -> records.

Counterpart of a subset of ``weightedld_tpu/runtime/driver.py``:
``DriverConfig`` (the fields this slice uses), ``LdSession`` (the
factorized-kernel decisions of ``driver.py:364-411`` and ``:666-785``,
batch dispatch with the keep / threshold / moments step of
``parallel/sharded.py:154-218`` minus the window and cross masks,
``summarize`` and ``stream``), ``stream_ld_records`` and ``run_to_tsv``
without a checkpoint.

A session uploads the padded site-major codes, the packed weights, the
per-site aux and the tile plan once; each batch then runs the factorized
kernel (:mod:`..ops.cuda_ld`), thresholds, and compacts its records on the
device.  Records stream in plan order — tile order, then (row, col) inside
a tile — as the JAX session on one device emits them.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
inputs the factorized kernel cannot take (UNKNOWN codes whose per-site
margins fail ``majmin_safe_with_unknown``), on-device Henikoff weights
(``weights=None``) and ``weight_quant='lo_int8'``.  Windows, cross plans,
analytics, checkpoints, streaming ingest and multiple devices are not in
``DriverConfig`` at all.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..core.ld_dense import LdRecords
from ..core.ld_tiled import compact_tile_stats
from ..device import resolve_device
from ..ops.cuda_ld import (
    build_majmin_planes,
    build_majmin_xq,
    detect_planes_unknown,
    majmin_safe_with_unknown,
    majmin_site_aux,
    pad_alignment_site_major,
    pad_weights,
    pad_weights_int8,
    tile_stats_majmin,
    tile_stats_majmin_pre,
    weights_bf16_exact,
)
from ..parallel.triangle import cdiv, plan_tiles, stripe

log = logging.getLogger("weightedld_tpu_torch")

_UNSET = object()  # "use the session default" sentinel (None is meaningful)

# The kernel stages 64 sequence columns per step (kKS in csrc/ld_majmin.cu):
# a partial step costs a whole one, so padding N up to a multiple of 64 is
# free, and 64-column chunks keep every staged word aligned.
SEQ_CHUNK_STEP = 64
# Largest chunk whose int32 joints convert to f32 exactly under the int8
# cascade (|J| <= 127 * chunk < 2^24): the f32 combine then rounds only in
# the scale products and sums, as with the JAX package's <= 2,048 chunks.
MAX_SEQ_CHUNK = 131072
DEFAULT_TILE = 256
# Device bytes per site pair of one batch: d, d' and r2 float32 plus keep.
_STAT_BYTES = 13


@dataclass
class DriverConfig:
    tile: int | None = None         # site-tile side (None = auto: 256)
    tiles_per_shard_batch: int | None = None  # tiles per dispatch (None =
                                    # auto: a 2 GiB stats budget on CUDA,
                                    # 8 on the CPU)
    r2_threshold: float | None = None  # None = emit every surviving pair
    seq_chunk: int | None = None    # sequence columns per f32 combine (None
                                    # = auto: all of N in one chunk, see
                                    # resolve_seq_chunk)
    weight_quant: str = "none"      # weighted-pass arithmetic: "none" =
                                    # the int8x3 cascade (full accuracy) |
                                    # "split_bf16" | "int8" (lossy);
                                    # "lo_int8" is not ported
    preplaned: str = "auto"         # "auto" | "on" | "off": precomputed
                                    # maj/dmin (+ xq) planes for the kernel


def resolve_tile(tile: int | None) -> int:
    """Site-tile side.  Auto: 256.  On the H100 the tile only sets the
    granularity of the plan, of the ``[K, T, T]`` batch outputs and of the
    diagonal waste: the kernel's CTA covers a 32 x 32 pair block whatever T
    is (any multiple of 32 keeps every thread busy).  At T = 256 a diagonal
    tile wastes half of 2^16 pairs, < 1% of the work for S >= 16k, and the
    plan stays small (18,528 tiles at S = 49,152).  An explicit ``tile``
    always wins."""
    return DEFAULT_TILE if tile is None else tile


def resolve_seq_chunk(seq_chunk: int | None, n_seqs: int) -> int:
    """Auto sequence chunk: one chunk for all of N, rounded up to the
    kernel's 64-column step, split evenly only past ``MAX_SEQ_CHUNK``.  On
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
                            device: torch.device) -> int:
    """Tiles per dispatch.  On CUDA: as many as fit a 2 GiB budget of batch
    outputs (13 B per pair; the threshold mask and the compaction add about
    as much again), a few GiB of the card's 80 GB.  At T = 256 that is
    2,520 tiles = 161,280 CTAs per launch, over a thousand waves on 132 SMs,
    so the per-batch launch and host round trip are amortized.  Without an
    r2 threshold every kept pair becomes a record (~40 B of device and host
    temporaries), so batches are capped at 1 GiB of records as well.  On
    the CPU (plain PyTorch path): 8 tiles, which bounds the float64 operand
    copies.  An explicit value always wins."""
    if tiles_per_batch is not None:
        return tiles_per_batch
    if device.type != "cuda":
        return max(1, min(8, n_tiles))
    t2 = tile * tile
    cap = max(1, (1 << 31) // (t2 * _STAT_BYTES))
    if r2_threshold is None:
        cap = min(cap, max(1, (1 << 30) // (t2 * 40)))
    return max(1, min(cap, n_tiles))


def plane_budget(device: torch.device) -> int:
    """Bytes the preplaned planes (+ xq) may take under ``preplaned="auto"``:
    half the card's free memory.  On the H100 the preplaned entry scanned
    faster than the codes entry at every N and S measured, and its set-up
    cost no more (PERF.md), so memory alone decides; the other half holds
    the codes during the plane build and the batch outputs.  On the CPU: 0,
    so the plain versions run from the codes and build no planes."""
    if device.type != "cuda":
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    return free // 2


class LdSession:
    """Device-resident all-pairs LD session on one device.

    Uploads the alignment (site-major, padded), the packed weights, the
    per-site aux and the tile plan once; each :meth:`stream` or
    :meth:`summarize` pass then runs one kernel launch per batch."""

    def __init__(self, alignment: np.ndarray, weights: np.ndarray | None,
                 site_map: np.ndarray, cfg: DriverConfig | None = None,
                 device: str | torch.device | None = None):
        cfg = cfg or DriverConfig()
        self.device = resolve_device(device)
        alignment = np.asarray(alignment)
        if alignment.ndim != 2:
            raise ValueError("alignment must be an [N, S] code matrix")
        self.n_seqs, self.n_sites = alignment.shape
        if weights is None:
            raise NotImplementedError(
                "weights=None (on-device Henikoff weights) is not ported to "
                "weightedld_tpu_torch yet (ROADMAP queue 1 item 11)")
        if cfg.weight_quant not in ("none", "split_bf16", "lo_int8", "int8",
                                    "int8x3"):
            raise ValueError(
                f"weight_quant must be none|split_bf16|lo_int8|int8|int8x3, "
                f"got {cfg.weight_quant!r}")
        if cfg.weight_quant == "lo_int8":
            raise NotImplementedError(
                "weight_quant='lo_int8' is not ported to weightedld_tpu_torch "
                "yet (ROADMAP queue 2 item 5)")
        if cfg.preplaned not in ("auto", "on", "off"):
            raise ValueError(
                f"preplaned must be auto|on|off, got {cfg.preplaned!r}")

        # No UNKNOWN anywhere (every VCF matrix; clean FASTA): per-pair
        # major/dmin are per-site properties and the factorized kernel is
        # exact.  With UNKNOWNs it still is when every site's count margins
        # absorb the worst per-pair removals.
        site_counts = None
        _planes, has_unknown = detect_planes_unknown(alignment)
        if has_unknown:
            from ..core.sites import site_histogram_host

            site_counts = site_histogram_host(alignment)
            if not majmin_safe_with_unknown(alignment, site_counts,
                                            n_seqs=self.n_seqs):
                raise NotImplementedError(
                    "this input has UNKNOWN codes whose per-site margins do "
                    "not make the factorized kernel exact; the general "
                    "P-plane kernel and the hybrid split are not ported to "
                    "weightedld_tpu_torch yet (ROADMAP queue 1 item 6, "
                    "queue 2 item 3)")

        tile = resolve_tile(cfg.tile)
        seq_chunk = resolve_seq_chunk(cfg.seq_chunk, self.n_seqs)
        self.plan = plan_tiles(self.n_sites, tile)
        k = resolve_tiles_per_batch(cfg.tiles_per_shard_batch,
                                    self.plan.n_tiles, tile,
                                    cfg.r2_threshold, self.device)
        cfg = replace(cfg, tile=tile, seq_chunk=seq_chunk,
                      tiles_per_shard_batch=k)
        self.cfg = cfg
        self.site_map = np.asarray(site_map)

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
        n_pad = cdiv(self.n_seqs, seq_chunk) * seq_chunk
        plane_bytes = (1 + nlev) * 2 * self.plan.s_pad * n_pad
        self._preplaned = cfg.preplaned == "on" or (
            cfg.preplaned == "auto"
            and plane_bytes <= plane_budget(self.device))
        # Keyword arguments of every kernel call of this session.
        self.kernel_kw = dict(tile=tile, n_sites=self.n_sites,
                              seq_chunk=seq_chunk, exact_weights=exact,
                              unit_weights=unit, wquant=wquant)

        if nlev:
            weights_host = pad_weights_int8(w_arr, seq_chunk, levels=nlev)
        else:
            weights_host = pad_weights(w_arr, seq_chunk)
        auxc, _auxr = majmin_site_aux(alignment, self.plan.s_pad,
                                      counts=site_counts)
        codes_host = pad_alignment_site_major(alignment, tile, seq_chunk)
        dev = self.device
        self.weights = w_arr
        self.weights_dev = torch.from_numpy(weights_host).to(dev)
        self.auxc_dev = torch.from_numpy(auxc).to(dev)
        codes_dev = torch.from_numpy(codes_host).to(dev)
        self.codes_dev = self.planes_dev = self.xq_dev = None
        if self._preplaned:
            self.planes_dev = build_majmin_planes(codes_dev, self.auxc_dev,
                                                  tile=tile)
            if nlev:
                self.xq_dev = build_majmin_xq(self.planes_dev,
                                              self.weights_dev, nlev)
        else:
            self.codes_dev = codes_dev
        del codes_dev

        # One shard: the stripe is the plan order.  Pad to whole batches
        # with non-emitting tiles, upload once, address batches by slice.
        tile_i, tile_j, emit = stripe(self.plan, 1)
        self.n_batches = cdiv(len(tile_i), k)
        total = self.n_batches * k
        ti = np.zeros(total, np.int32)
        tj = np.zeros(total, np.int32)
        em = np.zeros(total, np.int32)
        ti[:len(tile_i)] = tile_i
        tj[:len(tile_j)] = tile_j
        em[:len(emit)] = emit
        self.ti_dev = torch.from_numpy(ti).to(dev)
        self.tj_dev = torch.from_numpy(tj).to(dev)
        self.em_dev = torch.from_numpy(em).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # set-up time ends with its work

    @property
    def preplaned(self) -> bool:
        """Whether the session runs the preplaned kernel entry point."""
        return self._preplaned

    @property
    def operands(self) -> tuple[torch.Tensor, ...]:
        """The kernel's leading arguments: ``(planes, xq)`` for the preplaned
        entry, ``(codes,)`` for the codes entry."""
        if self._preplaned:
            return self.planes_dev, self.xq_dev
        return (self.codes_dev,)

    def batch_tiles(self, b: int) -> tuple[torch.Tensor, ...]:
        """``(tile_i, tile_j, emit)`` of batch ``b``, on the device."""
        k = self.cfg.tiles_per_shard_batch
        sl = slice(b * k, (b + 1) * k)
        return self.ti_dev[sl], self.tj_dev[sl], self.em_dev[sl]

    def _dispatch(self, b: int):
        """Run batch ``b``: ``(PairStats [K, T, T], tile_i, tile_j)``."""
        ti, tj, em = self.batch_tiles(b)
        fn = tile_stats_majmin_pre if self._preplaned else tile_stats_majmin
        st = fn(*self.operands, self.weights_dev, self.auxc_dev, ti, tj, em,
                **self.kernel_kw)
        return st, ti, tj

    def _threshold(self, r2_threshold) -> float:
        thr = self.cfg.r2_threshold if r2_threshold is _UNSET \
            else r2_threshold
        return -np.inf if thr is None else float(thr)

    def summarize(self, r2_threshold=_UNSET) -> dict:
        """Whole-triangle reduction: surviving pair count, count over the
        threshold, and r2 sum over threshold / max, with no records
        (``driver.py:1312-1342``; moments as ``sharded.py:195-218``)."""
        thr = self._threshold(r2_threshold)
        n_pairs = n_over = 0
        r2_sum = 0.0
        r2_max = -np.inf
        for b in range(self.n_batches):
            st, _ti, _tj = self._dispatch(b)
            mask = st.keep & (st.r2 > thr)
            n_pairs += int(st.keep.sum())
            n_over += int(mask.sum())
            r2_sum += float(torch.where(mask, st.r2,
                                        torch.zeros_like(st.r2)).sum())
            r2_max = max(r2_max, float(torch.where(
                st.keep, st.r2, torch.full_like(st.r2, -np.inf)).max()))
        return {
            "n_sequences": self.n_seqs,
            "n_sites": self.n_sites,
            "n_pairs": n_pairs,
            "n_over_threshold": n_over,
            "r2_sum_over_threshold": r2_sum,
            "r2_max": r2_max if n_pairs else None,
        }

    def stream(self, start_batch: int = 0, r2_threshold=_UNSET,
               ) -> Iterator[tuple[int, LdRecords]]:
        """Yield ``(batch_index, records)`` batch by batch; records carry
        exact float32 values.  ``r2_threshold`` overrides the session's
        threshold for this scan only."""
        thr = self._threshold(r2_threshold)
        t = self.cfg.tile
        for b in range(start_batch, self.n_batches):
            st, ti, tj = self._dispatch(b)
            _n, sites, values = compact_tile_stats(st, ti, tj, thr, tile=t)
            sites_h = sites.cpu().numpy()
            vals_h = values.cpu().numpy()
            yield b, LdRecords(
                pos_a=self.site_map[sites_h[:, 0]],
                pos_b=self.site_map[sites_h[:, 1]],
                d=vals_h[:, 0], d_prime=vals_h[:, 1], r2=vals_h[:, 2])


def stream_ld_records(alignment: np.ndarray, weights: np.ndarray,
                      site_map: np.ndarray, cfg: DriverConfig | None = None,
                      device: str | torch.device | None = None,
                      start_batch: int = 0,
                      ) -> Iterator[tuple[int, LdRecords]]:
    """Yield ``(batch_idx, records)`` for every tile batch of the triangle
    (one-shot wrapper over :class:`LdSession`)."""
    session = LdSession(alignment, weights, site_map, cfg, device)
    yield from session.stream(start_batch=start_batch)


def run_to_tsv(alignment: np.ndarray, weights: np.ndarray,
               site_map: np.ndarray, out_path: str | Path,
               cfg: DriverConfig | None = None,
               device: str | torch.device | None = None, ndigits: int = 4,
               timer=None) -> int:
    """Stream the triangle into a TSV file (header, then records in plan
    order); returns the number of records written.  ``timer`` collects the
    ``upload`` and ``scan+write`` spans."""
    from ..io.writer import open_text_output, pair_header, write_pairs
    from .profiling import StageTimer

    timer = timer or StageTimer()
    with timer.stage("upload"):
        session = LdSession(alignment, weights, site_map, cfg, device)
    log.info("tiled session: T=%d seq_chunk=%d tiles/batch=%d batches=%d "
             "preplaned=%s", session.cfg.tile, session.cfg.seq_chunk,
             session.cfg.tiles_per_shard_batch, session.n_batches,
             session.preplaned)
    n_written = 0
    t0 = time.monotonic()
    with open_text_output(out_path) as fh, timer.stage("scan+write"):
        fh.write(pair_header() + "\n")
        for _b, rec in session.stream():
            write_pairs(rec, fh, ndigits=ndigits, header=False)
            n_written += len(rec)
    log.info("%d records in %.3fs", n_written, time.monotonic() - t0)
    return n_written
