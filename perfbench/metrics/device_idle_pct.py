"""The device's idle share of the profiled stretch, in %: 100 × (1 − the
union of its kernel, copy and set intervals over the stretch)."""


def read(record):
    if record.device is None or record.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.device.busy_s / record.device.window_s)
