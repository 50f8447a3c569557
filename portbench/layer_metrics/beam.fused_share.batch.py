"""beam.fused_share.batch: % of the window's layer-0 beam steps that the
beam-step kernel ran (`DeviceIndex.steps`: "fused_steps" over "layer0"),
graphed or eager. None where the program has no such counter."""


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    before, after = steps
    if "fused_steps" not in before or "fused_steps" not in after:
        return None
    layer0 = after["layer0"] - before["layer0"]
    if not layer0:
        return None
    return 100.0 * (after["fused_steps"] - before["fused_steps"]) / layer0
