"""beam.graph_share.batch: % of the window's layer-0 beam steps that ran as
replays of a captured CUDA graph (`DeviceIndex.steps`: "graph_steps" over
"layer0"). None where the program has no such counter."""


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    before, after = steps
    if "graph_steps" not in before or "graph_steps" not in after:
        return None
    layer0 = after["layer0"] - before["layer0"]
    if not layer0:
        return None
    return 100.0 * (after["graph_steps"] - before["graph_steps"]) / layer0
