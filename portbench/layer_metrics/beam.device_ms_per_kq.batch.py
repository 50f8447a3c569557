"""beam.device_ms_per_kq.batch: device time (ms, from the profiler) of the
traced stretch's operations other than `pivot_entry_scan`'s, per 1,000
queries searched there (the queries of the stretch's pivot scans)."""

from portbench import spec


ROOFLINES = ("pivot_entry_scan",)  # the kernel calls this reads


def read(run):
    if run.trace is None or run.calls is None:
        return None
    queries = sum(s["B"] for s in run.calls.shapes.get("pivot_entry_scan", []))
    if not queries:
        return None
    pivot = spec.load_module("roofline", "pivot_entry_scan").KERNELS
    total = sum(b - a for _, a, b in run.trace.events)
    return 1000.0 * (total - run.trace.seconds_of(pivot)) / (queries / 1000.0)
