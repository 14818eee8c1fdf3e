"""The factorized major/dominant-minor LD tile kernel: CUDA wrappers, plain
PyTorch versions, and the host packers around them.

Counterpart of the factorized half of ``weightedld_tpu/ops/pallas_ld.py``:

* :func:`tile_stats_majmin` replaces ``pallas_tile_stats_majmin``
  (``pallas_ld.py:975``, kernel ``_ld_kernel_mm`` ``:847``): operands built
  from the site-major codes and the per-site aux;
* :func:`tile_stats_majmin_pre` replaces ``pallas_tile_stats_majmin_pre``
  (``:1219``, kernel ``_ld_kernel_mm_pre`` ``:1110``): operands read from
  planes precomputed by :func:`build_majmin_planes` / :func:`build_majmin_xq`.

Both launch the hand-written kernel of ``csrc/ld_majmin.cu`` for CUDA
tensors and run :func:`tile_stats_majmin_plain` /
:func:`tile_stats_majmin_pre_plain` for CPU tensors (the CPU tests and the
``--device cpu`` CLI); any other device raises.  Each launch adds one to
``launches[launch_name(<entry>, <weight kind>)]``.

Precondition (as in JAX): no UNKNOWN code anywhere, or every site's count
margins absorb the worst-case per-pair UNKNOWN removals
(:func:`majmin_safe_with_unknown`), so that major / dominant minor / the
distinct > 1 verdict are per-site properties (:func:`majmin_site_aux`) and
the four weighted {maj, dmin} cells factor into one (2T x 2T) contraction per
weight pass.

Weight layouts (``weights`` rows, all ``[rows, N_pad]`` float32, as JAX):
unit / bf16-exact / split_bf16: 1 row (``pad_weights``); ``lo_int8``: 3
rows w, q, alpha (``pad_weights_lo_int8``); ``int8``: 4 rows q1 q2 a1 a2 and
``int8x3``: 6 rows q1..q3 a1..a3 (``pad_weights_int8``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encode import N_ALLELES, N_CODES, UNKNOWN
from ..core.paircore import PairStats

DEFAULT_SEQ_CHUNK = 512
ALL_PLANES = (0, 1, 2, 3, 4)

# The weight modes of the kernels' weighted passes, one vocabulary (what a
# session resolves, :func:`resolve_weight_mode`): each mode's weight kind
# (:func:`weight_kind`), the int8 cascade levels of its packed weights (0:
# float rows) and the wrappers' JAX-shaped keywords.
WEIGHT_MODES = {
    mode: (kind, levels, dict(exact_weights=kind in ("unit", "exact"),
                              unit_weights=kind == "unit",
                              wquant=mode if kind in ("int", "lo") else ""))
    for mode, kind, levels in (
        ("unit", "unit", 0), ("bf16_exact", "exact", 0),
        ("split_bf16", "split", 0), ("lo_int8", "lo", 0), ("int8", "int", 2),
        ("int8x3", "int", 3))}
# Launch counts per kernel entry point, the float weight modes under names of
# their own: each wrapper adds one where it launches its kernel and nowhere
# else.
_MODE_SUFFIX = {WEIGHT_MODES[mode][0]: "_" + mode
                for mode in ("lo_int8", "split_bf16", "bf16_exact")}
launches = {entry + suffix: 0
            for entry in ("ld_majmin_codes", "ld_majmin_planes")
            for suffix in ("", *_MODE_SUFFIX.values())}


def launch_name(entry: str, kind: str) -> str:
    """The ``launches`` key of entry point ``entry`` in weight kind ``kind``
    (``_weight_mode``): the integer kinds count under the entry's name, the
    float kinds under ``<entry>_lo_int8``, ``_split_bf16`` or
    ``_bf16_exact``."""
    return entry + _MODE_SUFFIX.get(kind, "")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Host packers: numpy copies of pallas_ld.py's helpers.
# ---------------------------------------------------------------------------


def pad_alignment_site_major(alignment: np.ndarray, tile: int,
                             seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """``[N, S]`` sequence-major codes -> ``[S_pad, N_pad]`` site-major,
    padded with UNKNOWN (code 5) on both axes (copy of ``pallas_ld.py:
    77-97``).  From 2^24 int8 cells on, the native blocked OpenMP transpose
    (``io/native.py``) does it when the library is built; the numpy path
    is its oracle."""
    n, s = alignment.shape
    s_pad = -(-s // tile) * tile
    n_pad = -(-n // seq_chunk) * seq_chunk
    if alignment.size >= (1 << 24) and alignment.dtype == np.int8:
        from ..io import native

        if native.available():
            return native.transpose_pad_i8(alignment, s_pad, n_pad, UNKNOWN)
    out = np.full((s_pad, n_pad), UNKNOWN, dtype=np.int8)
    out[:s, :n] = alignment.T
    return out


def pad_weights(weights: np.ndarray,
                seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """``[1, N_pad]`` float32 weights, zero-padded (``pallas_ld.py:100-105``)."""
    n = weights.shape[0]
    n_pad = -(-n // seq_chunk) * seq_chunk
    out = np.zeros((1, n_pad), dtype=np.float32)
    out[0, :n] = weights
    return out


def pad_weights_lo_int8(weights: np.ndarray,
                        seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """``lo_int8`` weight packing, ``[3, N_pad]`` float32: row 0 = w, row 1 =
    q, the bf16 residual ``w - bf16(w)`` quantized to int8, row 2 = its
    scale alpha, so that ``w ~= bf16(w) + alpha * q`` (copy of
    ``pallas_ld.py:108-135``).  The bf16 rounding is torch's ``float32 ->
    bfloat16`` cast (round to nearest even, as ``ml_dtypes``); the rest is
    the JAX package's numpy arithmetic, operation for operation."""
    n = weights.shape[0]
    n_pad = -(-n // seq_chunk) * seq_chunk
    w32 = np.zeros(n_pad, dtype=np.float32)
    w32[:n] = np.asarray(weights, dtype=np.float32)
    w_hi = torch.from_numpy(w32).to(torch.bfloat16).to(torch.float32).numpy()
    w_lo = w32 - w_hi
    s = float(np.abs(w_lo).max())
    out = np.zeros((3, n_pad), dtype=np.float32)
    out[0] = w32
    if s > 0.0:
        out[1] = np.round(w_lo / s * 127.0).clip(-127, 127)
        out[2] = s / 127.0
    return out


def pad_weights_int8(weights: np.ndarray, seq_chunk: int = DEFAULT_SEQ_CHUNK,
                     levels: int = 2) -> np.ndarray:
    """Cascaded int8 weight packing, ``[2*levels, N_pad]`` float32 rows
    q1..qL / a1..aL with ``w ~= sum_l a_l * q_l`` (copy of
    ``pallas_ld.py:138-181``; levels=3 is the int8x3 default, error <= one
    f32 ulp of max|w|)."""
    n = weights.shape[0]
    n_pad = -(-n // seq_chunk) * seq_chunk
    w32 = np.zeros(n_pad, dtype=np.float32)
    w32[:n] = np.asarray(weights, dtype=np.float32)
    out = np.zeros((2 * levels, n_pad), dtype=np.float32)
    r = w32.astype(np.float64)  # exact residual cascade
    for lv in range(levels):
        s = float(np.abs(r).max())
        if s <= 0.0:
            break
        # Cascade the residual against the f32-rounded scale the kernel
        # recombines with, so the bound holds end to end.
        a = np.float32(s / 127.0)
        q = np.round(r / float(a)).clip(-127, 127)
        out[lv] = q
        out[levels + lv] = a
        r = r - float(a) * q
    return out


def weights_bf16_exact(weights: np.ndarray) -> bool:
    """True when every weight is exactly representable in bf16 (unit
    weights, simple fractions) — ``pallas_ld.py:624-630``, with the bf16
    round trip done by ``torch.bfloat16``."""
    w = torch.from_numpy(np.ascontiguousarray(weights, dtype=np.float32))
    return bool((w.to(torch.bfloat16).to(torch.float32) == w).all())


def resolve_weight_mode(weights: np.ndarray, weight_quant: str) -> str:
    """The weight mode (:data:`WEIGHT_MODES`) a session runs its ``float32``
    weights in, with JAX's precedence: unit weights, then bf16-exact ones,
    then ``weight_quant`` (``"none"`` is the int8x3 cascade)."""
    if bool((weights == 1.0).all()):
        return "unit"
    if weights_bf16_exact(weights):
        return "bf16_exact"
    return "int8x3" if weight_quant == "none" else weight_quant


def pack_weights(weights: np.ndarray, mode: str,
                 seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """The weight rows the kernels read in weight mode ``mode``."""
    kind, levels, _kw = WEIGHT_MODES[mode]
    if levels:
        return pad_weights_int8(weights, seq_chunk, levels=levels)
    if kind == "lo":
        return pad_weights_lo_int8(weights, seq_chunk)
    return pad_weights(weights, seq_chunk)


def detect_planes_unknown(alignment: np.ndarray) -> tuple:
    """``(planes, has_unknown)``: the allele codes 0..4 present and whether
    any UNKNOWN (code 5) cell exists (copy of ``pallas_ld.py:583-615``)."""
    n_rows = alignment.shape[0]
    row_bytes = max(1, alignment.shape[1] if alignment.ndim > 1 else 1)
    step = max(1, (1 << 24) // row_bytes)          # ~16 MB row chunks
    found = [False] * N_CODES
    for lo in range(0, n_rows, step):
        chunk = alignment[lo:lo + step]
        for c in range(N_CODES):
            if not found[c] and (chunk == c).any():
                found[c] = True
        if all(found):
            break
    planes = tuple(c for c in range(N_ALLELES) if found[c])
    if len(planes) < 2:
        planes = ALL_PLANES
    return planes, found[UNKNOWN]


def majmin_safe_with_unknown(alignment: np.ndarray | None,
                             counts: np.ndarray | None = None,
                             n_seqs: int | None = None) -> bool:
    """Whether the factorized kernel stays exact despite UNKNOWN cells:
    per site, with descending counts c1 >= c2 >= c3 over codes 0..4,
    ``c2 == 0`` or both margins exceed the worst per-pair removal count
    ``U_max`` (copy of ``pallas_ld.py:770-810``)."""
    from ..core.sites import site_histogram_host

    if counts is None:
        counts = site_histogram_host(alignment)
    counts = counts.astype(np.int64)
    if n_seqs is None:
        n_seqs = alignment.shape[0]
    u_max = int((n_seqs - counts.sum(axis=1)).max())
    if u_max == 0:
        return True
    top = np.sort(counts, axis=1)[:, ::-1]
    c1, c2, c3 = top[:, 0], top[:, 1], top[:, 2]
    safe = (c2 == 0) | ((c1 - c2 > u_max) & (c2 - c3 > u_max))
    return bool(safe.all())


_MARGIN_INF = np.int64(1) << 62


def majmin_site_margins(counts: np.ndarray, n_seqs: int,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-site ``(stability margin, UNKNOWN count)``: with descending
    counts c1 >= c2 >= c3, the margin is ``min(c1 - c2, c2 - c3)``, or
    ``_MARGIN_INF`` for a monomorphic site (copy of ``pallas_ld.py:
    1356-1369``).  Sites with UNKNOWN count ``u > 0`` are the only ones that
    can make a partner tile pair unsafe for the factorized kernel."""
    counts = counts.astype(np.int64)
    u = n_seqs - counts.sum(axis=1)
    top = np.sort(counts, axis=1)[:, ::-1]
    c1, c2, c3 = top[:, 0], top[:, 1], top[:, 2]
    margin = np.where(c2 == 0, _MARGIN_INF, np.minimum(c1 - c2, c2 - c3))
    return margin, u


def majmin_tile_margins(counts: np.ndarray, n_seqs: int, tile: int,
                        grid: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-site-tile ``(min margin, max UNKNOWN count)`` over each tile's
    real sites, ``[grid]`` int64 each; padded sites carry margin
    ``_MARGIN_INF`` and u = 0 (copy of ``pallas_ld.py:1313-1353``).  The
    tile pair (Ti, Tj) is factorized-exact iff ``(umax[Tj] == 0 or
    stab[Ti] > umax[Tj]) and (umax[Ti] == 0 or stab[Tj] > umax[Ti])``."""
    margin, u = majmin_site_margins(counts, n_seqs)
    s = counts.shape[0]
    s_pad = grid * tile
    mpad = np.full(s_pad, _MARGIN_INF, dtype=np.int64)
    mpad[:s] = margin
    upad = np.zeros(s_pad, dtype=np.int64)
    upad[:s] = u
    return (mpad.reshape(grid, tile).min(axis=1),
            upad.reshape(grid, tile).max(axis=1))


def majmin_site_aux(alignment: np.ndarray | None, s_pad: int,
                    counts: np.ndarray | None = None,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Per-site ``(major, dominant minor, distinct)`` for the factorized
    kernel: ``auxc [s_pad, 3]`` int32 and its transpose ``auxr [3, s_pad]``
    (copy of ``pallas_ld.py:813-844``).  Ties break to the smaller code;
    padded sites carry distinct == 0, which drops their pairs."""
    if counts is None:
        from ..core.sites import site_histogram_host

        counts = site_histogram_host(alignment)
    counts = counts.astype(np.int64)                            # [S, 5]
    s = counts.shape[0]
    score = counts * 8 + (N_ALLELES - np.arange(N_ALLELES))[None, :]
    maj = score.argmax(axis=1)
    score[np.arange(s), maj] = -1
    dmin = score.argmax(axis=1)
    auxc = np.zeros((s_pad, 3), dtype=np.int32)
    auxc[:s, 0] = maj
    auxc[:s, 1] = dmin
    auxc[:s, 2] = (counts > 0).sum(axis=1)
    return auxc, np.ascontiguousarray(auxc.T)


# ---------------------------------------------------------------------------
# Device-side operand builders (XLA code in JAX, torch ops here).
# ---------------------------------------------------------------------------


def build_majmin_planes(codes_sm: torch.Tensor, auxc: torch.Tensor, *,
                        tile: int) -> torch.Tensor:
    """``[S_pad, N_pad]`` int8 codes + ``[S_pad, 3]`` aux -> ``[2*S_pad,
    N_pad]`` int8 indicator planes, rows ``g*2T + i`` = ``codes[g*T+i] ==
    major`` and ``g*2T + T + i`` = the dominant-minor indicator, so each
    site tile's ``[maj; dmin]`` block is contiguous (``pallas_ld.py:1074``)."""
    s_pad, n_pad = codes_sm.shape
    grid = s_pad // tile
    aux8 = auxc[:, :2].to(torch.int8)
    cat = torch.stack([codes_sm == aux8[:, 0:1], codes_sm == aux8[:, 1:2]],
                      dim=1).to(torch.int8)                 # [S_pad, 2, N_pad]
    return cat.reshape(grid, tile, 2, n_pad).transpose(1, 2).reshape(
        grid * 2 * tile, n_pad).contiguous()


def build_majmin_xq(planes: torch.Tensor, weights_row: torch.Tensor,
                    nlev: int) -> torch.Tensor:
    """``[nlev, 2*S_pad, N_pad]`` int8: the planes scaled by each int8
    cascade level, ``xq_l = planes * q_l`` (``pallas_ld.py:1097``)."""
    q = weights_row[:nlev].to(torch.int8)                     # exact integers
    return torch.stack([planes * q[lv][None, :] for lv in range(nlev)])


# ---------------------------------------------------------------------------
# The pair algebra and the plain versions.
# ---------------------------------------------------------------------------


def pair_algebra(n_mm, n_md, n_dm, n_dd, keep):
    """D / D' / r2 and the frequency skip rules from the four weighted
    {maj, dmin} cells — ``pallas_ld.py:_pair_algebra`` (``:434-476``),
    operation for operation (reciprocal multiplied in; f32 compare with
    0.95)."""
    total_w = n_mm + n_md + n_dm + n_dd
    keep = keep & (total_w > 0)
    safe_w = torch.where(total_w > 0, total_w, torch.ones_like(total_w))
    inv_w = torch.div(torch.ones_like(safe_w), safe_w)

    pa_major = (n_mm + n_md) * inv_w
    pb_major = (n_mm + n_dm) * inv_w
    pa_minor = (n_dm + n_dd) * inv_w
    pb_minor = (n_md + n_dd) * inv_w
    keep = keep & (pa_major < 0.95) & (pb_major < 0.95)
    keep = keep & (n_mm + n_md > 0) & (n_mm + n_dm > 0)

    obs_mm = n_mm * inv_w
    obs_md = n_md * inv_w
    obs_dm = n_dm * inv_w
    obs_dd = n_dd * inv_w

    t0 = pa_major * pb_major - obs_mm
    t1 = pa_minor * pb_minor - obs_dd
    t2 = -(pa_major * pb_minor - obs_md)
    t3 = -(pa_minor * pb_major - obs_dm)
    d = (t0 + t1 + t2 + t3) * 0.25

    neg = torch.maximum(-obs_dd, -obs_mm)
    neg = torch.where(neg == 0, torch.minimum(-obs_dd, -obs_mm), neg)
    pos = torch.minimum(obs_dm, obs_md)
    pos = torch.where(pos == 0, torch.maximum(obs_dm, obs_md), pos)
    denom = torch.where(d < 0, neg, pos)
    d_prime = d / denom

    r2 = d * d / (pa_major * pa_minor * pb_major * pb_minor)
    return d, d_prime, r2, keep


def weight_kind(exact_weights: bool, unit_weights: bool, wquant: str) -> str:
    """The weight kind of the kernels' passes (:data:`WEIGHT_MODES`), with
    JAX's precedence: unit, then bf16-exact, then the int8 cascades
    (``"int"``), lo_int8 (``"lo"``) and split_bf16 (``"split"``,
    ``wquant=""``)."""
    if unit_weights:
        return "unit"
    if exact_weights:
        return "exact"
    if wquant not in ("", "lo_int8", "int8", "int8x3"):
        raise ValueError(f"unknown wquant {wquant!r}")
    return WEIGHT_MODES[wquant or "split_bf16"][0]


def _weight_mode(weights: torch.Tensor, exact_weights: bool,
                 unit_weights: bool, wquant: str) -> tuple[str, int]:
    """``(kind, nlev)`` of the weight passes (:func:`weight_kind`).
    ``"lo"`` (lo_int8) has one float pass of ``bf16(w)`` and one int8 level
    of the quantized residual (scale ``weights[2, 0]``)."""
    kind = weight_kind(exact_weights, unit_weights, wquant)
    nlev, rows = {"unit": (1, 1), "exact": (0, 1), "split": (0, 1),
                  "lo": (1, 3)}.get(kind, (0, 0))
    if kind == "int":
        nlev = WEIGHT_MODES[wquant][1]
        rows = 2 * nlev
    if weights.dim() != 2 or weights.shape[0] != rows:
        raise ValueError(
            f"weights layout {tuple(weights.shape)} does not match the "
            f"weight mode {kind!r} (expected {rows} rows)")
    return kind, nlev


def _float_rows(weights: torch.Tensor, kind: str) -> list[torch.Tensor]:
    """The f32 weight rows of the float passes: the bf16-exact weights,
    lo_int8's w_hi, or split_bf16's (w_hi, w_lo) — each the f32 value of a
    bf16 number."""
    w = weights[0]
    if kind == "exact":
        return [w]
    w_hi = w.to(torch.bfloat16).to(torch.float32)
    if kind == "lo":
        return [w_hi]
    w_lo = (w - w_hi).to(torch.bfloat16).to(torch.float32)
    return [w_hi, w_lo]


def float_pass_bits(weights: torch.Tensor, kind: str) -> torch.Tensor:
    """``[passes, N_pad]`` int16: the bf16 bits of each float pass the
    kernel multiplies into its B operand (the indicator's set halfwords
    take these bits, as ``xs * w_hi`` in ``pallas_ld.py:929``): the
    bf16-exact weights; split_bf16's w_hi and w_lo; lo_int8's w_hi and its
    int8 residual level q (an integer <= 127, exact in bf16)."""
    rows = _float_rows(weights, kind)
    if kind == "lo":
        rows = [*rows, weights[1]]
    return torch.stack(rows).to(torch.bfloat16).view(torch.int16) \
        .contiguous()


def _tile_rows(tiles: torch.Tensor, span: int) -> torch.Tensor:
    """Row indices ``[K, span]`` of each tile's ``span`` consecutive rows."""
    ar = torch.arange(span, device=tiles.device, dtype=torch.int64)
    return tiles.to(torch.int64)[:, None] * span + ar[None, :]


def _a_operands(x: torch.Tensor, weights: torch.Tensor, kind: str,
                nlev: int) -> list[torch.Tensor]:
    """The A-side operands of :func:`_cells_plain` from the 0/1 indicator
    ``x [..., N]``: ``x * q_l`` per int8 level, ``x`` alone for the unit and
    float kinds, ``[x, x * q]`` for lo_int8 (one-hot times int8 q fits
    int8)."""
    if kind == "int":
        q = weights[:nlev].to(torch.int8)
        return [x * q[lv] for lv in range(nlev)]
    if kind == "lo":
        return [x, x * weights[1].to(torch.int8)]
    return [x]


def _cells_plain(a_ops: list[torch.Tensor], y: torch.Tensor,
                 weights: torch.Tensor, kind: str, nlev: int,
                 seq_chunk: int) -> torch.Tensor:
    """``[K, 2T, 2T]`` f32 accumulator of the weighted {maj,dmin} cells.

    The int32 joints are computed exactly as float64 matrix products of the
    int8 operands (|q| <= 127, so every partial sum is an exact integer);
    float passes as float64 products rounded once to f32.  The f32 combine
    runs once per seq chunk, as the kernels do.  ``a_ops``: the int8 levels
    (``"int"``), the indicator (unit and float kinds), or for ``"lo"`` the
    indicator then its product with the residual level q."""
    n_pad = y.shape[-1]
    acc = None
    for c0 in range(0, n_pad, seq_chunk):
        sl = slice(c0, c0 + seq_chunk)
        yc = y[..., sl].to(torch.float64).transpose(1, 2)    # [K, Nc, 2T]
        cells = None
        if kind == "unit":
            cells = torch.bmm(a_ops[0][..., sl].to(torch.float64),
                              yc).to(torch.float32)
        elif kind == "int":
            for lv in range(nlev):
                j = torch.bmm(a_ops[lv][..., sl].to(torch.float64),
                              yc).to(torch.float32)
                term = weights[nlev + lv, 0] * j
                cells = term if cells is None else cells + term
        else:
            for w in _float_rows(weights, kind):
                xs = a_ops[0][..., sl].to(torch.float64) \
                    * w[sl].to(torch.float64)
                term = torch.bmm(xs, yc).to(torch.float32)
                cells = term if cells is None else cells + term
            if kind == "lo":         # + alpha * f32(J), pallas_ld.py:926-930
                j = torch.bmm(a_ops[1][..., sl].to(torch.float64),
                              yc).to(torch.float32)
                cells = cells + weights[2, 0] * j
        acc = cells if acc is None else acc + cells
    return acc


def _finalize_plain(acc, dist_a, dist_b, tile_i, tile_j, emit, tile,
                    n_sites) -> PairStats:
    t = tile
    keep = (dist_a[:, :, None] > 1) & (dist_b[:, None, :] > 1)
    return finalize_cells(acc[:, :t, :t], acc[:, :t, t:], acc[:, t:, :t],
                          acc[:, t:, t:], keep, tile_i, tile_j, emit, tile,
                          n_sites)


def finalize_cells(n_mm, n_md, n_dm, n_dd, keep, tile_i, tile_j, emit, tile,
                   n_sites) -> PairStats:
    """The pair algebra on ``[K, T, T]`` cells, then the strict upper
    triangle of true sites and the emit flag (``pallas_ld.py:550-560``)."""
    t = tile
    d, dp, r2, keep = pair_algebra(n_mm, n_md, n_dm, n_dd, keep)
    ar = torch.arange(t, device=n_mm.device, dtype=torch.int64)
    gi = tile_i.to(torch.int64)[:, None, None] * t + ar[None, :, None]
    gj = tile_j.to(torch.int64)[:, None, None] * t + ar[None, None, :]
    keep = keep & (gi < gj) & (gj < n_sites) & (emit[:, None, None] != 0)
    return PairStats(d=d.contiguous(), d_prime=dp.contiguous(),
                     r2=r2.contiguous(), keep=keep)


def tile_stats_majmin_plain(codes_sm, weights, auxc, tile_i, tile_j, emit, *,
                            tile: int, n_sites: int,
                            seq_chunk: int = DEFAULT_SEQ_CHUNK,
                            exact_weights: bool = False,
                            unit_weights: bool = False,
                            wquant: str = "") -> PairStats:
    """Plain PyTorch version of :func:`tile_stats_majmin` (any device)."""
    kind, nlev = _weight_mode(weights, exact_weights, unit_weights, wquant)
    k = tile_i.shape[0]
    rows_i = _tile_rows(tile_i, tile)
    rows_j = _tile_rows(tile_j, tile)

    def indicators(rows):
        a = codes_sm[rows.reshape(-1)].reshape(k, tile, -1)
        aux = auxc[rows.reshape(-1)].reshape(k, tile, 3).to(torch.int8)
        return torch.cat([a == aux[:, :, 0:1], a == aux[:, :, 1:2]],
                         dim=1).to(torch.int8)                # [K, 2T, N]

    x = indicators(rows_i)
    y = indicators(rows_j)
    acc = _cells_plain(_a_operands(x, weights, kind, nlev), y, weights, kind,
                       nlev, seq_chunk)
    return _finalize_plain(acc, auxc[rows_i, 2], auxc[rows_j, 2], tile_i,
                           tile_j, emit, tile, n_sites)


def tile_stats_majmin_pre_plain(planes, xq, weights, auxc, tile_i, tile_j,
                                emit, *, tile: int, n_sites: int,
                                seq_chunk: int = DEFAULT_SEQ_CHUNK,
                                exact_weights: bool = False,
                                unit_weights: bool = False,
                                wquant: str = "") -> PairStats:
    """Plain PyTorch version of :func:`tile_stats_majmin_pre` (any device)."""
    kind, nlev = _weight_mode(weights, exact_weights, unit_weights, wquant)
    k = tile_i.shape[0]
    prow_i = _tile_rows(tile_i, 2 * tile).reshape(-1)
    prow_j = _tile_rows(tile_j, 2 * tile).reshape(-1)
    y = planes[prow_j].reshape(k, 2 * tile, -1)
    if kind == "int":
        a_ops = [xq[lv][prow_i].reshape(k, 2 * tile, -1)
                 for lv in range(nlev)]
    else:
        # lo_int8 builds its one xq level from the planes, as JAX does
        # in-kernel (pallas_ld.py:1173-1177).
        a_ops = _a_operands(planes[prow_i].reshape(k, 2 * tile, -1), weights,
                            kind, nlev)
    acc = _cells_plain(a_ops, y, weights, kind, nlev, seq_chunk)
    return _finalize_plain(acc, auxc[_tile_rows(tile_i, tile), 2],
                           auxc[_tile_rows(tile_j, tile), 2], tile_i, tile_j,
                           emit, tile, n_sites)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel.
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            want is not None and want != got
            for want, got in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(weights, auxc, tile_i, tile_j, emit, *, s_pad, n_pad,
                  tile, n_sites, seq_chunk, device, exact_weights,
                  unit_weights, wquant) -> tuple[str, int]:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if tile <= 0 or s_pad % tile:
        raise ValueError(f"S_pad={s_pad} is not a multiple of tile={tile}")
    if seq_chunk <= 0 or seq_chunk % 4 or n_pad % seq_chunk:
        raise ValueError(f"N_pad={n_pad} must be a multiple of seq_chunk="
                         f"{seq_chunk}, itself a multiple of 4")
    if not 0 <= n_sites <= s_pad:
        raise ValueError(f"n_sites={n_sites} outside [0, S_pad={s_pad}]")
    _check("weights", weights, torch.float32, (None, n_pad), device)
    if auxc is not None:            # the general kernel takes no aux
        _check("auxc", auxc, torch.int32, (s_pad, 3), device)
    k = tile_i.shape[0] if isinstance(tile_i, torch.Tensor) else -1
    for nm, t in (("tile_i", tile_i), ("tile_j", tile_j), ("emit", emit)):
        _check(nm, t, torch.int32, (k,), device)
    if k > 0:
        grid = s_pad // tile
        ok = (torch.minimum(tile_i.min(), tile_j.min()) >= 0) \
            & (torch.maximum(tile_i.max(), tile_j.max()) < grid)
        msg = f"tile indices outside [0, {grid})"
        if device.type == "cuda":
            # Checked on the card, as PyTorch's indexing does: a host read
            # here would wait for every earlier launch before this one.
            torch._assert_async(ok, msg)
        elif not bool(ok):
            raise ValueError(msg)
    return _weight_mode(weights, exact_weights, unit_weights, wquant)


def _launch(name: str, src0: int, src1: int, weights, auxc, tile_i,
            tile_j, emit, *, kind, nlev, tile, n_sites, s_pad, n_pad,
            seq_chunk) -> PairStats:
    """Launch ``name`` on the current stream; ``src0``/``src1`` are the
    operand-source pointers (codes and q, or planes and xq).  Temporaries
    made here are freed after the call in stream order, after the kernel."""
    from ._build import load_library

    dev = weights.device
    k = tile_i.shape[0]
    scale_ptr = wb_ptr = 0
    nflt = 0
    if kind == "unit":
        scale = torch.ones(1, dtype=torch.float32, device=dev)
    elif kind == "int":
        scale = weights[nlev:2 * nlev, 0].contiguous()
    elif kind == "lo":
        scale = weights[2:3, 0].contiguous()
    else:
        scale, nlev = None, 0
    if scale is not None:
        scale_ptr = scale.data_ptr()
    if kind in ("exact", "split", "lo"):
        wb = float_pass_bits(weights, kind)
        wb_ptr, nflt = wb.data_ptr(), wb.shape[0] - nlev
    d = torch.empty((k, tile, tile), dtype=torch.float32, device=dev)
    dp = torch.empty_like(d)
    r2 = torch.empty_like(d)
    keep = torch.empty((k, tile, tile), dtype=torch.int8, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            src0, src1, scale_ptr, wb_ptr, auxc.data_ptr(),
            tile_i.data_ptr(), tile_j.data_ptr(), emit.data_ptr(),
            d.data_ptr(), dp.data_ptr(), r2.data_ptr(), keep.data_ptr(),
            k, tile, n_sites, s_pad, n_pad, seq_chunk, nlev, nflt, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    if k > 0:
        launches[launch_name(name, kind)] += 1
    return PairStats(d=d, d_prime=dp, r2=r2, keep=keep.view(torch.bool))


def _q_levels(weights: torch.Tensor, kind: str,
              nlev: int) -> torch.Tensor | None:
    """``[levels, N_pad]`` int8 weight levels a kernel multiplies into an
    operand: ones (unit), q1..qL (the int8 cascades), lo_int8's q row (the
    general kernel; the factorized one takes it as a bf16 pass,
    :func:`float_pass_bits`); None for the other float kinds."""
    if kind == "unit":
        return torch.ones((1, weights.shape[1]), dtype=torch.int8,
                          device=weights.device)
    if kind == "int":
        return weights[:nlev].to(torch.int8).contiguous()
    if kind == "lo":
        return weights[1:2].to(torch.int8).contiguous()
    return None


def tile_stats_majmin(codes_sm, weights, auxc, tile_i, tile_j, emit, *,
                      tile: int, n_sites: int,
                      seq_chunk: int = DEFAULT_SEQ_CHUNK,
                      exact_weights: bool = False, unit_weights: bool = False,
                      wquant: str = "") -> PairStats:
    """LD statistics ``[K, T, T]`` (d, d_prime, r2 float32, keep bool) for K
    tile pairs, from ``[S_pad, N_pad]`` int8 site-major codes and the
    ``[S_pad, 3]`` int32 aux of :func:`majmin_site_aux` — the contract of
    ``pallas_tile_stats_majmin`` (its row-layout ``auxr`` is not needed)."""
    device = codes_sm.device
    s_pad = codes_sm.shape[0]
    n_pad = codes_sm.shape[1] if codes_sm.dim() == 2 else -1
    _check("codes_sm", codes_sm, torch.int8, (s_pad, n_pad), device)
    kind, nlev = _check_common(
        weights, auxc, tile_i, tile_j, emit, s_pad=s_pad, n_pad=n_pad,
        tile=tile, n_sites=n_sites, seq_chunk=seq_chunk, device=device,
        exact_weights=exact_weights, unit_weights=unit_weights,
        wquant=wquant)
    kw = dict(tile=tile, n_sites=n_sites, seq_chunk=seq_chunk,
              exact_weights=exact_weights, unit_weights=unit_weights,
              wquant=wquant)
    if device.type == "cpu":
        return tile_stats_majmin_plain(codes_sm, weights, auxc, tile_i,
                                       tile_j, emit, **kw)
    q_ptr = 0
    if kind in ("unit", "int"):
        q = _q_levels(weights, kind, nlev)
        q_ptr = q.data_ptr()
    return _launch("ld_majmin_codes", codes_sm.data_ptr(), q_ptr, weights,
                   auxc, tile_i, tile_j, emit, kind=kind, nlev=nlev,
                   tile=tile, n_sites=n_sites, s_pad=s_pad, n_pad=n_pad,
                   seq_chunk=seq_chunk)


def tile_stats_majmin_pre(planes, xq, weights, auxc, tile_i, tile_j, emit, *,
                          tile: int, n_sites: int,
                          seq_chunk: int = DEFAULT_SEQ_CHUNK,
                          exact_weights: bool = False,
                          unit_weights: bool = False,
                          wquant: str = "") -> PairStats:
    """Preplaned twin of :func:`tile_stats_majmin` — identical outputs.
    ``planes`` is ``[2*S_pad, N_pad]`` int8 from :func:`build_majmin_planes`;
    ``xq`` the ``[nlev, 2*S_pad, N_pad]`` int8 of :func:`build_majmin_xq`
    for the int8 cascades, else None (lo_int8 scales the planes by its
    one level inline, as ``_ld_kernel_mm_pre`` does)."""
    device = planes.device
    s2 = planes.shape[0]
    n_pad = planes.shape[1] if planes.dim() == 2 else -1
    _check("planes", planes, torch.int8, (s2, n_pad), device)
    if s2 % 2:
        raise ValueError(f"planes has an odd row count {s2}")
    s_pad = s2 // 2
    kind, nlev = _check_common(
        weights, auxc, tile_i, tile_j, emit, s_pad=s_pad, n_pad=n_pad,
        tile=tile, n_sites=n_sites, seq_chunk=seq_chunk, device=device,
        exact_weights=exact_weights, unit_weights=unit_weights,
        wquant=wquant)
    if kind == "int":
        _check("xq", xq, torch.int8, (nlev, s2, n_pad), device)
    kw = dict(tile=tile, n_sites=n_sites, seq_chunk=seq_chunk,
              exact_weights=exact_weights, unit_weights=unit_weights,
              wquant=wquant)
    if device.type == "cpu":
        return tile_stats_majmin_pre_plain(planes, xq, weights, auxc, tile_i,
                                           tile_j, emit, **kw)
    # Unit weights read the planes as their single int8 level; the float
    # kinds read the planes alone and build their B rows from the planes
    # and the bf16 pass bits in-kernel (lo_int8's planes * q too, as JAX
    # builds xq in-kernel for this mode).
    xq_ptr = xq.data_ptr() if kind == "int" else planes.data_ptr()
    return _launch("ld_majmin_planes", planes.data_ptr(), xq_ptr, weights,
                   auxc, tile_i, tile_j, emit, kind=kind, nlev=nlev,
                   tile=tile, n_sites=n_sites, s_pad=s_pad, n_pad=n_pad,
                   seq_chunk=seq_chunk)
