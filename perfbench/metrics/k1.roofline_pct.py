"""K1's share of its roofline over the sub-window's calls, in %."""

from perfbench.roofline import roofline_pct


def read(rec):
    return roofline_pct(rec, "k1")
