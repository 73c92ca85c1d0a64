"""The card spans each encoder block of SigLIP so400m records inside a
runner chunk's ``card.compute`` (``sparkdl_tpu_torch/models/siglip.py``):
``card.attention`` and ``card.mlp``, one of each per block and chunk."""

from __future__ import annotations

from typing import Optional

from perfbench import cardspans
from perfbench.reference.siglip_so400m import LAYERS


def card_ms_per_batch(rec, name: str) -> Optional[float]:
    """Σ of the sub-window's ``name`` spans over its runner batches, in
    ms; None where the card lane reads nothing (``cardspans.read``) or
    the spans are not one per block of every batch."""
    got = cardspans.read(rec)
    if got is None:
        return None
    spans = [c for c in got[1] if c.name == name]
    if len(spans) != LAYERS * rec.batches:
        return None
    return 1e3 * sum(c.end - c.start for c in spans) / rec.batches
