"""A FASTA alignment of clade-structured sequences with IUPAC ambiguity
codes, for the test that adds a masked FASTA configuration by files alone
(``test_ldbench_fasta_config.py`` copies this file into a root's
``ldbench/generators/``).

The shape is that of bulk-sequenced HIV-1 *pol* genotypes: a root
sequence, ``n_clades`` clade consensuses that differ from it at a share of
the variable columns, and per sequence a few variants more at variable
columns, ``third_frac`` of them a third base.  Mixtures are called as the
two-base codes R Y K M S W or as N, ``mixture_frac`` of all bases,
``mixture_at_variable`` of them at the variable columns; each sequence's
ends are trimmed to gaps (``-``) by up to ``trim_max`` columns;
``lower_frac`` of the sequences are written in lower case; lines wrap at
``line_width``.  The matrix is drawn on the device from the seed with one
``torch.Generator``.

Codes as the program's reader gives them: A C G T = 0..3, ``-`` = 4, any
ambiguity code = 5.  ``positions`` are the column indices from 0, the
numbering of a FASTA job's sites (its site map is ``np.where(ld_mask)``).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_BASE = b"RYKMSW"


def generate(params: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    n, s = int(params["n_seqs"]), int(params["n_sites"])

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    root = randint(0, 4, s)
    alt = (root + randint(1, 4, s)) % 4          # another base per column
    var = rand(s) < float(params["variable_frac"])
    clade = randint(0, int(params["n_clades"]), n)
    flip = (rand(int(params["n_clades"]), s)
            < float(params["clade_frac"])) & var
    own = (rand(n, s) < float(params["within_frac"])) & var
    codes = torch.where(flip[clade] ^ own, alt, root)
    # A share of the sequences' own variants is a third base.
    third = torch.where((alt + 1) % 4 == root, (alt + 2) % 4, (alt + 1) % 4)
    codes = torch.where(own & (rand(n, s) < float(params["third_frac"])),
                        third, codes)
    mix, at_var = float(params["mixture_frac"]), float(
        params["mixture_at_variable"])
    vf = var.float().mean().clamp(min=1e-9)
    p_mix = torch.where(var, mix * at_var / vf, mix * (1 - at_var) / (1 - vf))
    ambiguous = rand(n, s) < p_mix
    codes = torch.where(ambiguous, 5, codes)
    trim = int(params["trim_max"]) + 1
    col = torch.arange(s, device=dev)
    ends = ((col[None, :] < randint(0, trim, n, 1))
            | (col[None, :] >= s - randint(0, trim, n, 1)))
    codes = torch.where(ends, 4, codes).to(torch.int8)

    # The text: ACGT-, an ambiguity letter where the code is 5 (N with
    # probability n_frac), lower case on a share of the sequences.
    lut = torch.tensor(list(b"ACGT-N"), dtype=torch.uint8, device=dev)
    letters = torch.tensor(list(TWO_BASE), dtype=torch.uint8, device=dev)
    ch = lut[codes.to(torch.int64)]
    two = letters[randint(0, len(TWO_BASE), n, s)]
    ch = torch.where((codes == 5) & (rand(n, s) >= float(params["n_frac"])),
                     two, ch)
    lower = (rand(n, 1) < float(params["lower_frac"])) & (codes != 4)
    ch = torch.where(lower, ch + 32, ch)
    width = int(params["line_width"])
    text = np.full((n, s + -(-s // width)), ord("\n"), dtype=np.uint8)
    at = np.arange(s)
    text[:, at + at // width] = ch.cpu().numpy()

    def write(path) -> None:
        with open(path, "wb") as fh:
            for i in range(n):
                fh.write(b">s%d\n" % i)
                fh.write(text[i].data)

    return {"codes": codes.cpu().numpy(),
            "positions": np.arange(s, dtype=np.int64), "suffix": ".fasta",
            "write": write}
