"""weightedld_tpu_torch — the PyTorch / CUDA port of weightedld_tpu.

Weighted linkage disequilibrium (Henikoff-weighted D, D' and r2 over all
site pairs of a FASTA alignment or a multi-sample VCF) on an NVIDIA H100.
The JAX package ``weightedld_tpu`` is the reference this port is held
against; the module layout and names follow it, and the top level exports
the same names (``weightedld_tpu/__init__.py:14-57``), so ``import
weightedld_tpu_torch as wld`` takes the place of ``import weightedld_tpu as
wld``.  Every function that computes on a device takes ``device`` (default
``cuda``; the CPU only by name, ``"cpu"``).  This package imports ``torch``
and never ``jax``; its CUDA kernels are built from ``csrc/`` at first use.
``docs/API_TORCH.md`` lists each name's device contract.

The sessions of ``session_from_vcf`` / ``session_from_fasta``
(``runtime.driver.LdSession``) stream their records with
``stream(start_batch=0, r2_threshold=..., on_progress=None,
decimals=None)``: ``decimals`` in 0..4 yields D and r2 rounded on the
device as Python's ``round(x, decimals)`` rounds them (D' exact), for text
at that many digits; ``None`` yields exact float32 values.
"""

from .core.encode import encode_alignment
from .core.henikoff import henikoff_weights
from .core.ld_dense import LdRecords, extract_records, ld_all_pairs_dense
from .core.paircore import PairStats, finalize_pair_tile, ld_pair_tile, pair_tables
from .core.sites import compute_variable_sites
from .device import resolve_device
from .io.fasta import read_fasta
from .io.vcf import list_chromosomes, parse_region, read_vcf, vcf_sample_names
from .pipeline import PipelineResult, WldConfig, prepare, run, site_stats
from .runtime.ingest import (
    prepare_fasta_streamed,
    prepare_vcf_streamed,
    session_from_fasta,
    session_from_vcf,
)

__version__ = "0.1.0"

__all__ = [
    "encode_alignment",
    "henikoff_weights",
    "LdRecords",
    "extract_records",
    "ld_all_pairs_dense",
    "PairStats",
    "finalize_pair_tile",
    "ld_pair_tile",
    "pair_tables",
    "compute_variable_sites",
    "read_fasta",
    "read_vcf",
    "list_chromosomes",
    "parse_region",
    "vcf_sample_names",
    "prepare_fasta_streamed",
    "session_from_fasta",
    "PipelineResult",
    "WldConfig",
    "prepare",
    "run",
    "site_stats",
    "prepare_vcf_streamed",
    "session_from_vcf",
    "resolve_device",
    "__version__",
]
