"""device.idle.batch: percent of the traced stretch in which no operation
(kernel, copy or set) ran on the device: 1 less the union of their
intervals over the stretch (`torch.profiler`)."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
