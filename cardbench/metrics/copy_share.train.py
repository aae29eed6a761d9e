"""Percent of the device time in the profiler's window spent in copy
and cast operations (``harness.device_category``)."""


def read(run):
    t = run.traced
    if not t or not t["device_s"]:
        return None
    return 100.0 * t["by_category_s"].get("copy_cast", 0.0) / t["device_s"]
