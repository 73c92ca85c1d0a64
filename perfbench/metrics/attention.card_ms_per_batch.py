"""The encoder blocks' attention, card ms per runner batch: every
``card.attention`` span (LN1, the q, k and v projections, the fused
attention, the output projection and its residual add) over the
sub-window's batches; None unless there is one per block of every
batch."""

from perfbench import blockspans


def read(rec):
    return blockspans.card_ms_per_batch(rec, "card.attention")
