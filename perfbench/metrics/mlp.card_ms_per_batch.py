"""The encoder blocks' MLP, card ms per runner batch: every ``card.mlp``
span (LN2, fc1, GELU, fc2 and its residual add) over the sub-window's
batches; None unless there is one per block of every batch."""

from perfbench import blockspans


def read(rec):
    return blockspans.card_ms_per_batch(rec, "card.mlp")
