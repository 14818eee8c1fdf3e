"""The weighted-LD pair engine as dense tensor algebra, in PyTorch.

Counterpart of ``weightedld_tpu/core/paircore.py:67-230``: the same
functions, the same operation order, on torch tensors of any device.  For a
tile of sites ``A`` and a tile ``B``:

* ``Jw[a, b, s, t] = sum_n w_n [codes[n,a]==s] [codes[n,b]==t]`` is the
  weighted joint allele table over alleles 0..4 (code 5 joins no cell, which
  is the reference's first filtering pass, ``WeightedLD.py:183-186``);
* ``Ju`` is the same with unit weights; its marginals are the per-pair
  post-filter allele counts (``WeightedLD.py:194-211``).

:func:`finalize_pair_tile` then picks major / dominant minor (ties to the
smaller code, score ``count * 8 + (5 - code)``), applies the skip rules and
computes D, D' and r2 (reference ``WeightedLD.py:183-284``; see the JAX
module's docstring for every parity note).  This module is the dense
engine's core and the CPU oracle of the port.

The contractions run in float32.  On CUDA that relies on PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 == False``: TF32 keeps about three
decimal digits and would corrupt the weighted sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encode import N_ALLELES


class PairStats(NamedTuple):
    """Per-pair LD statistics over a tile: all tensors shaped [..., T_a, T_b]."""

    d: torch.Tensor
    d_prime: torch.Tensor
    r2: torch.Tensor
    keep: torch.Tensor  # bool: pair survived every skip rule


def one_hot_alleles(codes: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[N, T] -> [N, T, 5]`` one-hot over allele codes 0..4 (code 5 -> all-zero)."""
    alleles = torch.arange(N_ALLELES, dtype=codes.dtype, device=codes.device)
    return (codes[:, :, None] == alleles).to(dtype)


def pair_tables(codes_a: torch.Tensor, codes_b: torch.Tensor,
                weights: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Jw, Ju)``, each ``[T_a, T_b, 5, 5]``, for ``[N, T]`` code slices
    and ``[N]`` weights (see module docstring)."""
    oh_a = one_hot_alleles(codes_a, dtype)              # [N, Ta, 5]
    oh_b = one_hot_alleles(codes_b, dtype)              # [N, Tb, 5]
    oh_aw = oh_a * weights.to(dtype)[:, None, None]
    jw = torch.einsum("nas,nbt->abst", oh_aw, oh_b)
    ju = torch.einsum("nas,nbt->abst", oh_a, oh_b)
    return jw, ju


def major_dom_minor(cnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Major and dominant-minor allele codes from ``[..., 5]`` int32 counts;
    ties pick the smallest code (``lib.rs:126-140``)."""
    codes = torch.arange(N_ALLELES, dtype=torch.int32, device=cnt.device)
    score = cnt * 8 + (N_ALLELES - codes)
    major = torch.argmax(score, dim=-1).to(torch.int32)
    masked = torch.where(codes == major[..., None],
                         torch.full_like(score, -1), score)
    dom_minor = torch.argmax(masked, dim=-1).to(torch.int32)
    return major, dom_minor


def _select2(jw: torch.Tensor, sa: torch.Tensor,
             tb: torch.Tensor) -> torch.Tensor:
    """``jw[a, b, sa[a,b], tb[a,b]]`` for ``jw`` shaped [Ta, Tb, 5, 5]."""
    row = torch.take_along_dim(jw, sa[:, :, None, None].long(), dim=2)[:, :, 0, :]
    return torch.take_along_dim(row, tb[:, :, None].long(), dim=2)[:, :, 0]


def finalize_pair_tile(jw: torch.Tensor, ju: torch.Tensor) -> PairStats:
    """Element-wise LD finalization over a pair tile (``paircore.py:141-219``)."""
    cnt_a = torch.round(ju.sum(dim=3)).to(torch.int32)    # [Ta, Tb, 5]
    cnt_b = torch.round(ju.sum(dim=2)).to(torch.int32)

    distinct_a = (cnt_a > 0).sum(dim=-1)
    distinct_b = (cnt_b > 0).sum(dim=-1)
    keep = (distinct_a > 1) & (distinct_b > 1)              # WeightedLD.py:196-201

    maj_a, dmin_a = major_dom_minor(cnt_a)
    maj_b, dmin_b = major_dom_minor(cnt_b)

    n_mm = _select2(jw, maj_a, maj_b)
    n_md = _select2(jw, maj_a, dmin_b)
    n_dm = _select2(jw, dmin_a, maj_b)
    n_dd = _select2(jw, dmin_a, dmin_b)

    total_w = n_mm + n_md + n_dm + n_dd
    keep = keep & (total_w > 0)
    safe_w = torch.where(total_w > 0, total_w, torch.ones_like(total_w))

    pa_major = (n_mm + n_md) / safe_w
    pb_major = (n_mm + n_dm) / safe_w
    pa_minor = (n_dm + n_dd) / safe_w
    pb_minor = (n_md + n_dd) / safe_w

    # round(P, 1) == 1.0 <=> P >= double(0.95), evaluated as an f32 compare
    # against f32(0.95) (torch compares a float32 tensor with a Python scalar
    # in float32), exactly like the JAX engine.
    keep = keep & (pa_major < 0.95) & (pb_major < 0.95)
    keep = keep & (n_mm + n_md > 0) & (n_mm + n_dm > 0)

    obs_mm = n_mm / safe_w
    obs_md = n_md / safe_w
    obs_dm = n_dm / safe_w
    obs_dd = n_dd / safe_w

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
    d_prime = d / denom                  # inf/nan on zero denom, as reference

    r2 = d * d / (pa_major * pa_minor * pb_major * pb_minor)

    return PairStats(d=d, d_prime=d_prime, r2=r2, keep=keep)


def ld_pair_tile(codes_a: torch.Tensor, codes_b: torch.Tensor,
                 weights: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> PairStats:
    """Full LD statistics for every (site in A) x (site in B) pair."""
    jw, ju = pair_tables(codes_a, codes_b, weights, dtype)
    return finalize_pair_tile(jw, ju)
