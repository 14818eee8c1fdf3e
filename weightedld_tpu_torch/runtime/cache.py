"""Prepared-input persistence.

Copy of ``weightedld_tpu/runtime/cache.py:1-66``: saves and loads the
post-ingest pipeline state (encoded alignment, site map, weights, masks)
as a compressed ``.npz``, so that parsing and weighting run once and later
scans (other thresholds, resumed triangles) start from the array cache.
The format is the JAX package's (``_FORMAT_VERSION = 2``, the same keys),
so a cache written by either package loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..pipeline import PipelineResult

_FORMAT_VERSION = 2


def save_prepared(path: str | Path, res: PipelineResult,
                  prep_config: dict | None = None) -> None:
    import json

    # Write through an explicit handle: np.savez_compressed(path, ...)
    # silently appends ".npz" to bare paths, which would break the
    # save/load round trip for any other extension.
    with open(path, "wb") as fh:
        np.savez_compressed(
            fh,
            format_version=_FORMAT_VERSION,
            alignment=res.alignment,
            site_map=res.site_map,
            weights=res.weights,
            hk_mask=res.hk_mask if res.hk_mask is not None
            else np.empty(0, bool),
            ld_mask=res.ld_mask if res.ld_mask is not None
            else np.empty(0, bool),
            prep_config=np.frombuffer(
                json.dumps(prep_config or {}).encode(), dtype=np.uint8
            ),
        )


def load_prepared(path: str | Path) -> tuple[PipelineResult, dict]:
    """Returns (result, prep_config) — the config the cache was built with,
    so callers can detect preparation flags that a cached load ignores."""
    import json

    with np.load(path) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"{path}: prepared-cache format {version} != {_FORMAT_VERSION}"
            )
        hk = z["hk_mask"]
        ld = z["ld_mask"]
        prep = json.loads(bytes(z["prep_config"]).decode() or "{}")
        return PipelineResult(
            alignment=z["alignment"],
            site_map=z["site_map"],
            weights=z["weights"],
            hk_mask=hk if hk.size else None,
            ld_mask=ld if ld.size else None,
        ), prep
