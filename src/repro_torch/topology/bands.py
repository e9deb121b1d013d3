"""K-banded sub-bucketing: powers-of-two user-axis pads.

A bucket pads every row's user axis to its largest fleet.  That is right
for near-K grids, but a ``users=[8, 1024, 10240]`` grid would run its
8-user row at width 10240.  Banding splits a bucket's rows into
powers-of-two K *bands* (8 → band 8, 1024 → band 1024, 10240 → band
16384): one device loop per band, each padded to the band width, and
within a band the active-mask contract applies unchanged, so host ledgers
stay bitwise the unbanded (and the solo) run's.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["band_width", "split_bands"]


def band_width(k: int) -> int:
    """Smallest power of two >= k (the band's padded user-axis width)."""
    if k < 1:
        raise ValueError(f"band_width needs k >= 1, got {k}")
    return 1 << (k - 1).bit_length()


def split_bands(rows: List) -> Dict[int, List]:
    """Group bucket rows (anything with ``.spec.k``) by band, preserving
    first-seen band order and row order within each band."""
    bands: Dict[int, List] = {}
    for row in rows:
        bands.setdefault(band_width(row.spec.k), []).append(row)
    return bands
