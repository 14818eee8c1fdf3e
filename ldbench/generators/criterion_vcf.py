"""The upstream criterion bench's sites, written as a phased GT-only VCF.

The distribution is that of WeightedLD's criterion bench
(``rust/weighted_ld/benches/bench_weighted_pair_ld.rs:8-28``,
``make_sequence``): every cell independently the major allele with
probability ``major_frac``, missing with ``missing_frac``, else the minor
allele; copied from ``bench.py:39-44`` (REF = 0, ALT = 1 here, as a VCF
holds them, where ``bench.py`` writes codes 0 and 3).  The file is written
as ``chip_smoke.py:1143-1170`` (``write_vcf``) writes the project's
headline VCF: diploid ``a|b`` genotypes over consecutive haplotypes, ``.``
for a missing allele, POS = ``first_pos`` + the site index.  The matrix is
drawn on the device from the seed with one ``torch.Generator``.

Codes: REF = 0, ALT = 1, missing = 4.  The VCF reader returns haplotype
rows in the reversed file order, so the file holds ``codes[::-1]``.
"""

from __future__ import annotations

import numpy as np
import torch


def generate(params: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    n = int(params["n_seqs"])
    s = int(params["n_sites"])
    major = float(params["major_frac"])
    missing = float(params["missing_frac"])
    r = torch.rand((n, s), generator=g, device=dev)
    codes = torch.where(r < major, 0,
                        torch.where(r < 1.0 - missing, 1, 4)).to(torch.int8)
    body = _genotype_rows(codes)
    codes_h = codes.cpu().numpy()
    pos_h = int(params["first_pos"]) + np.arange(s, dtype=np.int64)
    chrom = str(params["chrom"])

    def write(path) -> None:
        head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{i}" for i in range(n // 2)) + "\n")
        with open(path, "wb") as fh:
            fh.write(head.encode())
            for i in range(s):
                fh.write(f"{chrom}\t{pos_h[i]}\trs{i + 1}\tA\tT\t100\tPASS\t."
                         "\tGT\t".encode())
                fh.write(body[i].data)

    return {"codes": codes_h, "positions": pos_h, "suffix": ".vcf",
            "write": write}


def _genotype_rows(codes: torch.Tensor) -> np.ndarray:
    """``[S, row bytes]`` uint8: per site the ``a|b`` genotypes of every
    sample, tab-separated, ending in a newline; haplotype rows reversed."""
    haps = codes.flip(0).to(torch.int64)
    lut = torch.zeros(8, dtype=torch.uint8, device=codes.device)
    lut[0], lut[1], lut[4] = ord("0"), ord("1"), ord(".")
    ch = lut[haps]
    n, s = ch.shape
    g = torch.empty((s, n // 2, 4), dtype=torch.uint8, device=codes.device)
    g[:, :, 0] = ch[0::2].T
    g[:, :, 1] = ord("|")
    g[:, :, 2] = ch[1::2].T
    g[:, :, 3] = ord("\t")
    g[:, -1, 3] = ord("\n")
    return g.reshape(s, -1).cpu().numpy()
