"""Input bytes the runner wrote into its staging buffers
(``RunnerMetrics.bytes_staged``) per image: a count."""


def read(rec):
    if not rec.images:
        return None
    return rec.runner["bytes_staged"] / rec.images
