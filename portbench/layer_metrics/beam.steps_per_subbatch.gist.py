"""beam.steps_per_subbatch.gist: serial layer-0 beam steps per search
sub-batch in the window (`DeviceIndex.steps`: "layer0" over "batches"), as
`beam.steps_per_subbatch.batch` reads them."""

from portbench import spec


def read(run):
    return spec.load_module("layer_metrics", "beam.steps_per_subbatch.batch").read(run)
