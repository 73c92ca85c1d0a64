"""Device ms per runner batch of every op but K1, K2 and copies: the
model's own kernels (convs, BatchNorm, casts, pools)."""


def read(rec):
    if not rec.batches or not rec.device_ops:
        return None
    skip = (rec.kernel("k1").PATTERN, rec.kernel("k2").PATTERN)
    seconds = sum(e - s for n, s, e in rec.device_ops
                  if not n.startswith(("Memcpy", "Memset"))
                  and not any(p in n for p in skip))
    return 1e3 * seconds / rec.batches
