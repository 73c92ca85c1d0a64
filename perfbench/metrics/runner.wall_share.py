"""The runner's wall (``device.run_seconds``, serialised by the engine's
device lock) as a share of the sub-window, in %."""


def read(rec):
    if "device.run_seconds" not in rec.counters:
        return None
    return 100.0 * rec.counters["device.run_seconds"] / rec.window_s
