"""weightedld_tpu_torch — the PyTorch / CUDA port of weightedld_tpu.

Weighted linkage disequilibrium (Henikoff-weighted D, D' and r2 over all
site pairs of a FASTA alignment or a multi-sample VCF) on an NVIDIA H100.
The JAX package ``weightedld_tpu`` is the reference this port is held
against; the module layout and names follow it.  This package imports
``torch`` and never ``jax``; its CUDA kernels are built from ``csrc/`` at
first use.  See ROADMAP.md for what is ported so far.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
