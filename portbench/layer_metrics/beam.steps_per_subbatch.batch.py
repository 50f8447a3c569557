"""beam.steps_per_subbatch.batch: serial layer-0 beam steps per search
sub-batch in the window (`DeviceIndex.steps`: "layer0" over "batches")."""


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    before, after = steps
    batches = after["batches"] - before["batches"]
    return (after["layer0"] - before["layer0"]) / batches if batches else None
