"""device.idle.gist: percent of the traced stretch in which no operation
(kernel, copy or set) ran on the device, as `device.idle.batch` reads it."""

from portbench import spec


def read(run):
    return spec.load_module("layer_metrics", "device.idle.batch").read(run)
