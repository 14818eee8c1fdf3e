"""Symbol alphabet and sequence encoding.

Copy of ``weightedld_tpu/core/encode.py:1-54`` (numpy only).  Parity
contract (reference ``WeightedLD.py:34-40``): characters are lowercased,
then

    a -> 0, c -> 1, g -> 2, t -> 3, '-' -> 4 (gap / missing),
    anything else -> 5 (ambiguous / unknown).

Codes 0..3 are the concrete nucleotides, code 4 is a gap (a real allele for
weighting and LD, but not site coverage), and code 5 is "no information"
(sequences carrying it at a site drop out of every per-site / per-pair
computation).
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
GAP = 4          # '-' in FASTA; missing genotype ('.') in VCF
UNKNOWN = 5      # ambiguous IUPAC characters and anything unrecognised

N_CONCRETE = 4   # codes < 4 count toward site coverage (ref WeightedLD.py:68)
N_ALLELES = 5    # codes 0..4 participate in histograms   (ref WeightedLD.py:74-75)
N_CODES = 6

ALIGNMENT_DTYPE = np.int8

# 256-entry character lookup table: byte value -> symbol code.
_CHAR_LUT = np.full(256, UNKNOWN, dtype=ALIGNMENT_DTYPE)
for _ch, _code in (("a", A), ("c", C), ("g", G), ("t", T), ("-", GAP)):
    _CHAR_LUT[ord(_ch)] = _code
    _CHAR_LUT[ord(_ch.upper())] = _code


def encode_sequence_bytes(raw: bytes) -> np.ndarray:
    """Encode one sequence (raw ASCII bytes) to symbol codes (int8 vector)."""
    return _CHAR_LUT[np.frombuffer(raw, dtype=np.uint8)]


def encode_alignment(rows: list[bytes]) -> np.ndarray:
    """Encode equal-length sequences into an ``[n_seqs, n_sites]`` int8 matrix."""
    if not rows:
        raise ValueError("empty alignment")
    length = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) != length:
            raise ValueError(
                f"ragged alignment: sequence {i} has length {len(r)}, expected {length}"
            )
    buf = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(rows), length)
    return _CHAR_LUT[buf]
