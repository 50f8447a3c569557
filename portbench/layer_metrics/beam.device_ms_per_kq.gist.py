"""beam.device_ms_per_kq.gist: device time (ms, from the profiler) of the
traced stretch's operations other than `pivot_entry_scan`'s, per 1,000
queries searched there, as `beam.device_ms_per_kq.batch` reads it."""

from portbench import spec


ROOFLINES = ("pivot_entry_scan",)  # the kernel calls this reads


def read(run):
    return spec.load_module("layer_metrics", "beam.device_ms_per_kq.batch").read(run)
