"""The fused attention kernel's share of its roofline over the
sub-window's calls, in %: the summed bound of each call's work
(``kernels/attention.py``: the blocks' calls, and the head's where the
same kernel runs it) over the calls' device time. None unless each
runner batch made one call per block, or one more."""


def read(rec):
    k = rec.kernel("attention")
    calls, seconds = rec.op_time(k.PATTERN)
    if not calls or seconds <= 0 or not rec.batches:
        return None
    per_batch, rest = divmod(calls, rec.batches)
    head = per_batch - k.ENCODER_CALLS
    if rest or head not in (0, 1):
        return None
    batch = rec.geometry["batch"]
    bound = (k.ENCODER_CALLS * k.bound_s(*k.work(batch))
             + head * k.bound_s(*k.work(batch, queries=1)))
    return 100.0 * rec.batches * bound / seconds
