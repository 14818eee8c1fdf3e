"""The generator of the ``hiv_pol_iupac`` configuration: a FASTA alignment
of clade-structured HIV-1 *pol* genotypes with IUPAC ambiguity codes.

The code lives in ``ldbench/tests/iupac_fasta.py``, where the test that
adds a masked FASTA configuration by files alone
(``test_ldbench_fasta_config.py``) copies it from; this file loads that one
copy by path, so the benchmark and the test draw the same alignment from a
seed.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_SOURCE = Path(__file__).resolve().parents[1] / "tests" / "iupac_fasta.py"
_spec = importlib.util.spec_from_file_location("ldbench_iupac_fasta_source",
                                               _SOURCE)
_source = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_source)

TWO_BASE = _source.TWO_BASE
generate = _source.generate
