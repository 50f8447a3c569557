"""beam.row_roofline.gist: percent of the memory's roofline that the
layer-0 beam's row traffic reached in the traced stretch.

The rows whose distance the beam evaluated, per query, over the whole
window (`DeviceIndex.steps`: "dist_rows" over "queries", each row D
elements of the mirror's dtype), times the queries searched in the
stretch (the stretch's `pivot_entry_scan` calls), is the least the beam
read there: those bytes at the memory's bandwidth, over the stretch's
device time other than the pivot scan's. None where the program has no
such counters, or the stretch no call or no operation."""

from portbench import peaks, spec


ROOFLINES = ("pivot_entry_scan",)  # the kernel calls this reads
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def read(run):
    steps = run.counters.get("steps")
    if not steps or run.trace is None or run.calls is None:
        return None
    before, after = steps
    if any(key not in s for s in (before, after) for key in ("queries", "dist_rows")):
        return None
    queries = after["queries"] - before["queries"]
    calls = run.calls.shapes.get("pivot_entry_scan", [])
    if not queries or not calls:
        return None
    dim = run.cell.config["data"]["dim"]
    elem = ELEMENT_BYTES[run.cell.config["deployment"]["tpu"]["device_dtype"]]
    row_bytes = (after["dist_rows"] - before["dist_rows"]) * dim * elem / queries
    stretch_queries = sum(s["B"] for s in calls)
    pivot = spec.load_module("roofline", "pivot_entry_scan").KERNELS
    device_s = sum(b - a for _, a, b in run.trace.events) - run.trace.seconds_of(pivot)
    if device_s <= 0.0:
        return None
    least = row_bytes * stretch_queries / peaks.HBM_BYTES_PER_S
    return 100.0 * least / device_s
