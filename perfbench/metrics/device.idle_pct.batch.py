"""The card's idle share of the window's passes outside the profiled
sub-window, in %: 100 x (1 - the card's busy seconds per image, the
union of its kernel and copy intervals in the sub-window over the
sub-window's images, times those passes' images over their seconds).
The profiler slows a host-paced pass and leaves the card's own times
as they are, so the card's busy time comes from the trace and the pace
from the passes it did not slow."""


def read(rec):
    if not rec.device_ops or not rec.images or not rec.plain_images:
        return None
    busy_per_image = rec.busy_s / rec.images
    return 100.0 * (1.0 - busy_per_image * rec.plain_images / rec.plain_s)
