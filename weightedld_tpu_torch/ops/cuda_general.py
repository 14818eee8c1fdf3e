"""The general P-plane LD tile kernel: CUDA wrapper, plain PyTorch version
and the one-hot plane builder.

Counterpart of ``pallas_tile_stats`` (``weightedld_tpu/ops/pallas_ld.py:
658-764``) and its two kernels, ``_ld_kernel`` (``:184-358``, weighted) and
``_ld_kernel_unit`` (``:361-431``, unit weights), both finished by
``_ld_finalize`` (``:479-560``).  This kernel runs where the factorized one
of :mod:`.cuda_ld` is not proven exact: the unsafe tile pairs of a hybrid
session, and every tile pair under ``kernel="general"``.

Per site pair the reference drops the sequences whose code is outside the
``planes`` at either site, then recomputes major and dominant minor from the
remaining counts (``WeightedLD.py:183-211``):

* ``cnt_a[s] = #{A == planes[s], B valid}`` and ``cnt_b[u] = #{A valid,
  B == planes[u]}``, where valid means the code is one of the ``planes``
  (the union of the one-hot planes, not ``code != UNKNOWN``: a caller may
  restrict ``planes`` and out-of-plane codes then drop out of the counts);
* major / dominant minor are the best / second-best score ``count * 8 +
  (5 - code)`` (ties to the smaller code), and ``distinct > 1`` is required
  on both sides;
* the four {maj, dmin} cells are read from the weighted joint table.

:func:`tile_stats_general` launches ``csrc/ld_general.cu`` for CUDA tensors
(``ld_general``, ``ld_general_unit``, or ``ld_general_planes`` for the
preplaned operands of :func:`build_planes_tiled`) and runs
:func:`tile_stats_general_plain` for CPU tensors; any other device raises.
The kernel contracts the whole P x P joint of every weight pass on the
tensor cores, plus a unit pass whose marginals are the counts, and selects
the four cells per pair afterwards (the note at the top of the source); the
float passes reach it as bf16 bits (:func:`.cuda_ld.float_pass_bits`).
Each launch adds one to ``launches[<kernel name>]``, the float weight modes
under names of their own (``ld_general_lo_int8``,
``ld_general_split_bf16``, ``ld_general_bf16_exact`` and their
``ld_general_planes_*`` twins).  Weight layouts are those of
:mod:`.cuda_ld`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.encode import N_ALLELES
from ..core.paircore import PairStats
from .cuda_ld import (
    ALL_PLANES,
    DEFAULT_SEQ_CHUNK,
    WEIGHT_MODES,
    _cells_plain,
    _a_operands,
    _check,
    _check_common,
    _q_levels,
    _tile_rows,
    _weight_mode,
    finalize_cells,
    float_pass_bits,
    launch_name,
    weight_kind,
)

# Launch counts per kernel entry point, the float weight modes (lo_int8,
# split_bf16, bf16-exact) under names of their own (``launch_name``): the
# wrapper adds one where it launches a kernel and nowhere else.
launches = {**{launch_name(entry, kind): 0
               for entry in ("ld_general", "ld_general_planes")
               for kind in ("int", "lo", "split", "exact")},
            "ld_general_unit": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_planes_tiled(codes_sm: torch.Tensor, *, tile: int,
                       planes: tuple = ALL_PLANES) -> torch.Tensor:
    """``[S_pad, N_pad]`` int8 codes -> ``[grid * P * T, N_pad]`` int8
    one-hot planes, row ``g*P*T + s*T + i`` = ``codes[g*T + i] ==
    planes[s]``, so each site tile's ``(P*T, N)`` block is contiguous (copy
    of ``pallas_ld.py:634-652``)."""
    s_pad, n_pad = codes_sm.shape
    grid = s_pad // tile
    p = len(planes)
    oh = torch.stack([codes_sm == c for c in planes], dim=1).to(torch.int8)
    return oh.reshape(grid, tile, p, n_pad).transpose(1, 2).reshape(
        grid * p * tile, n_pad).contiguous()


def _one_hot(src, tiles, tile, planes, preplaned) -> torch.Tensor:
    """``[K, P, T, N]`` int8 one-hot planes of each listed site tile."""
    k, p = tiles.shape[0], len(planes)
    if preplaned:
        return src[_tile_rows(tiles, p * tile).reshape(-1)].reshape(
            k, p, tile, -1)
    codes = src[_tile_rows(tiles, tile).reshape(-1)].reshape(k, tile, -1)
    return torch.stack([codes == c for c in planes], dim=1).to(torch.int8)


def _major_dmin(cnt: torch.Tensor, planes: tuple):
    """Plane indices of the best and second-best score ``count * 8 + (5 -
    code)`` over ``cnt [K, P, T, T]`` — ``_ld_finalize``'s ``major_dmin``
    (``pallas_ld.py:503-521``), loop for loop."""
    neg = torch.full(cnt.shape[:1] + cnt.shape[2:], -1, dtype=torch.int64,
                     device=cnt.device)
    best, best_idx = neg, torch.zeros_like(neg)
    for s, code in enumerate(planes):
        score = cnt[:, s] * 8 + (N_ALLELES - code)
        better = score > best
        best = torch.where(better, score, best)
        best_idx = torch.where(better, s, best_idx)
    second, second_idx = neg, torch.zeros_like(neg)
    for s, code in enumerate(planes):
        score = cnt[:, s] * 8 + (N_ALLELES - code)
        better = (score > second) & (best_idx != s)
        second = torch.where(better, score, second)
        second_idx = torch.where(better, s, second_idx)
    return best_idx, second_idx


def tile_stats_general_plain(src, weights, tile_i, tile_j, emit, *,
                             tile: int, n_sites: int,
                             seq_chunk: int = DEFAULT_SEQ_CHUNK,
                             planes: tuple = ALL_PLANES,
                             exact_weights: bool = False,
                             unit_weights: bool = False, wquant: str = "",
                             preplaned: bool = False) -> PairStats:
    """Plain PyTorch version of :func:`tile_stats_general` (any device).

    Joints are float64 matrix products of the int8 one-hot operands, exact
    for the counts and the int8 passes; the weighted joint is combined in
    f32 once per seq chunk (``_ld_kernel``), the unit joint converted to
    f32 once after all of N (``_ld_kernel_unit``).  Counts come from the
    validity planes as in ``_ld_kernel``; they equal the unit kernel's
    joint marginals."""
    kind, nlev = _weight_mode(weights, exact_weights, unit_weights, wquant)
    planes = tuple(int(c) for c in planes)
    k, p, t = tile_i.shape[0], len(planes), tile
    x = _one_hot(src, tile_i, t, planes, preplaned)           # [K, P, T, N]
    y = _one_hot(src, tile_j, t, planes, preplaned)
    f64 = torch.float64
    vx = x.amax(dim=1).to(f64)                                # [K, T, N]
    vy = y.amax(dim=1).to(f64)
    xf = x.reshape(k, p * t, -1)
    yf = y.reshape(k, p * t, -1)
    cnt_a = torch.bmm(xf.to(f64), vy.transpose(1, 2)).round().to(
        torch.int64).reshape(k, p, t, t)                      # (s, i, j)
    cnt_b = torch.bmm(vx, yf.to(f64).transpose(1, 2)).round().to(
        torch.int64).reshape(k, t, p, t).transpose(1, 2)      # (u, i, j)

    a_ops = _a_operands(xf, weights, kind, nlev)
    # The unit kernel accumulates its int32 joint over every chunk and
    # converts once: one chunk spanning N gives the same single rounding.
    chunk = yf.shape[-1] if kind == "unit" else seq_chunk
    jw = _cells_plain(a_ops, yf, weights, kind, nlev, chunk).reshape(
        k, p, t, p, t)                                        # [K,s,i,u,j]

    maj_a, dmin_a = _major_dmin(cnt_a, planes)
    maj_b, dmin_b = _major_dmin(cnt_b, planes)
    keep = ((cnt_a > 0).sum(dim=1) > 1) & ((cnt_b > 0).sum(dim=1) > 1)
    dev = jw.device
    kk = torch.arange(k, device=dev)[:, None, None]
    ii = torch.arange(t, device=dev)[None, :, None]
    jj = torch.arange(t, device=dev)[None, None, :]
    # Selecting a cell returns the joint entry itself, as the reference's
    # masked sums do (jw * 1.0 plus zeros).
    n_mm = jw[kk, maj_a, ii, maj_b, jj]
    n_md = jw[kk, maj_a, ii, dmin_b, jj]
    n_dm = jw[kk, dmin_a, ii, maj_b, jj]
    n_dd = jw[kk, dmin_a, ii, dmin_b, jj]
    return finalize_cells(n_mm, n_md, n_dm, n_dd, keep, tile_i, tile_j, emit,
                          t, n_sites)


def work_block(n_planes: int, *, exact_weights: bool = False,
               unit_weights: bool = False, wquant: str = "",
               preplaned: bool = False) -> tuple[int, int]:
    """``(kSA, kSB)``: the A sites and B sites of one work item of the body
    that :func:`tile_stats_general` launches for ``n_planes`` planes in
    this weight mode and entry, as the library names it
    (``ld_general_block``, host only: nothing runs on the card)."""
    from ._build import load_library

    kind = weight_kind(exact_weights, unit_weights, wquant)
    nlev = {"int": WEIGHT_MODES.get(wquant, (0, 0))[1], "lo": 1}.get(kind, 0)
    nflt = {"exact": 1, "split": 2, "lo": 1}.get(kind, 0)
    sa, sb = ctypes.c_int(), ctypes.c_int()
    rc = load_library().ld_general_block(
        n_planes, nlev, nflt, int(kind == "unit"), int(preplaned),
        ctypes.byref(sa), ctypes.byref(sb))
    if rc != 0:
        raise ValueError(f"no general kernel for P={n_planes} in weight "
                         f"kind {kind!r}")
    return sa.value, sb.value


def live_spans(tile_i, tile_j, emit, *, tile: int, n_sites: int,
               block: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)``, each ``[K, ceil(T / kSA)]``: the live B blocks ``lo..hi``
    of each A block of the general kernel's work items of ``block = (kSA,
    kSB)`` sites (:func:`work_block`) on the host tile tables ``tile_i``,
    ``tile_j``, ``emit``; ``lo > hi`` where none is.  A work item is live,
    and runs, where its tile pair emits and it holds a pair ``gi < gj <
    n_sites``: the closed form of ``live_span`` in ``csrc/ld_general.cu``."""
    sa, sb = block
    na, nb = -(-tile // sa), -(-tile // sb)
    ti = np.asarray(tile_i, dtype=np.int64)[:, None]
    bt = np.asarray(tile_j, dtype=np.int64)[:, None] * tile
    a0 = ti * tile + np.arange(na, dtype=np.int64) * sa      # [K, na]
    room = n_sites - bt                    # B sites below n_sites
    hi = np.where(room > 0, np.minimum(nb - 1, (room - 1) // sb), -1)
    need = a0 + 2 - bt                     # a0 < b1: (bj + 1) kSB >= need
    lo = np.where(need <= 0, 0, -(-need // sb) - 1)
    ok = ((np.asarray(emit)[:, None] != 0) & (a0 + 2 <= n_sites)
          & (need <= tile))
    return lo, np.where(ok, hi, -1)


def work_items(tile_i, tile_j, emit, *, tile: int, n_sites: int,
               block: tuple[int, int]) -> tuple[int, int]:
    """``(items, live_items)`` of one general kernel launch on these host
    tile tables: its work items of ``block`` sites, and the live ones it
    runs (:func:`live_spans`)."""
    lo, hi = live_spans(tile_i, tile_j, emit, tile=tile, n_sites=n_sites,
                        block=block)
    nb = -(-tile // block[1])
    return lo.size * nb, int(np.maximum(hi - lo + 1, 0).sum())


def _launch(name: str, entry: str, codes, planes_src, weights, tile_i,
            tile_j, emit, *, kind, nlev, tile, n_sites, s_pad, n_pad,
            seq_chunk, planes) -> PairStats:
    """Launch ``entry`` of ``csrc/ld_general.cu`` on the current stream and
    count it under ``name``.  Temporaries made here are freed after the
    call in stream order, after the kernel."""
    from ._build import load_library

    dev = weights.device
    k = tile_i.shape[0]
    q = scale = wb = None
    nflt = 0
    if kind == "int":
        q = _q_levels(weights, kind, nlev)
        scale = weights[nlev:2 * nlev, 0].contiguous()
    elif kind == "lo":
        scale = weights[2:3, 0].contiguous()
    if kind in ("exact", "split", "lo"):
        # The bf16 bits of the float passes (lo_int8: w_hi, then its
        # residual level q, exact in bf16).
        wb = float_pass_bits(weights, kind)
        nflt = wb.shape[0] - nlev
    ptr = lambda t: 0 if t is None else t.data_ptr()
    packed = sum(c << (3 * s) for s, c in enumerate(planes))
    d = torch.empty((k, tile, tile), dtype=torch.float32, device=dev)
    dp = torch.empty_like(d)
    r2 = torch.empty_like(d)
    keep = torch.empty((k, tile, tile), dtype=torch.int8, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            ptr(codes), ptr(planes_src), ptr(q), ptr(scale), ptr(wb),
            tile_i.data_ptr(), tile_j.data_ptr(), emit.data_ptr(),
            d.data_ptr(), dp.data_ptr(), r2.data_ptr(), keep.data_ptr(),
            k, tile, n_sites, s_pad, n_pad, seq_chunk, nlev, nflt,
            len(planes), packed, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")
    if k > 0:
        launches[launch_name(name, kind)] += 1
    return PairStats(d=d, d_prime=dp, r2=r2, keep=keep.view(torch.bool))


def tile_stats_general(src, weights, tile_i, tile_j, emit, *, tile: int,
                       n_sites: int, seq_chunk: int = DEFAULT_SEQ_CHUNK,
                       planes: tuple = ALL_PLANES,
                       exact_weights: bool = False,
                       unit_weights: bool = False, wquant: str = "",
                       preplaned: bool = False) -> PairStats:
    """LD statistics ``[K, T, T]`` (d, d_prime, r2 float32, keep bool) for K
    tile pairs — the contract of ``pallas_tile_stats``.  ``src`` is the
    ``[S_pad, N_pad]`` int8 site-major codes, or with ``preplaned`` the
    ``[grid * P * T, N_pad]`` 0/1 planes of :func:`build_planes_tiled`
    built with the same ``planes``."""
    planes = tuple(int(c) for c in planes)
    if not 1 <= len(planes) <= N_ALLELES or len(set(planes)) != len(planes) \
            or not all(0 <= c < N_ALLELES for c in planes):
        raise ValueError(f"planes must be distinct allele codes 0..4, got "
                         f"{planes}")
    device = src.device
    rows = src.shape[0]
    n_pad = src.shape[1] if src.dim() == 2 else -1
    _check("planes" if preplaned else "codes_sm", src, torch.int8,
           (rows, n_pad), device)
    if preplaned:
        if rows % len(planes):
            raise ValueError(f"{rows} plane rows are not a multiple of "
                             f"P={len(planes)}")
        s_pad = rows // len(planes)
    else:
        s_pad = rows
    kind, nlev = _check_common(
        weights, None, tile_i, tile_j, emit, s_pad=s_pad, n_pad=n_pad,
        tile=tile, n_sites=n_sites, seq_chunk=seq_chunk, device=device,
        exact_weights=exact_weights, unit_weights=unit_weights,
        wquant=wquant)
    kw = dict(tile=tile, n_sites=n_sites, seq_chunk=seq_chunk, planes=planes,
              exact_weights=exact_weights, unit_weights=unit_weights,
              wquant=wquant, preplaned=preplaned)
    if device.type == "cpu":
        return tile_stats_general_plain(src, weights, tile_i, tile_j, emit,
                                        **kw)
    entry = "ld_general_unit" if kind == "unit" else "ld_general"
    name = "ld_general_planes" if preplaned else entry
    return _launch(name, entry, None if preplaned else src,
                   src if preplaned else None, weights, tile_i, tile_j, emit,
                   kind=kind, nlev=nlev, tile=tile, n_sites=n_sites,
                   s_pad=s_pad, n_pad=n_pad, seq_chunk=seq_chunk,
                   planes=planes)
