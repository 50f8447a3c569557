"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), and a kernel's
share of its roofline.

The rates are NVIDIA's data sheet, dense (no sparsity), at the card's
full 700 W power limit; a run reports the power limit it found beside its
numbers. An FMA counts as two operations.
"""

from __future__ import annotations

from typing import Optional

OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of `kind` and bytes over the memory's bandwidth."""
    return max(ops / OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S)


def roofline_share(run, kernel: str) -> Optional[float]:
    """Percent of its roofline that `kernel` reached in the traced
    stretch: the least time of the calls made there (`roofline/<kernel>.py`
    counts their work from their shapes) over the device time of the
    kernel's launches there. None where no call or no launch was seen."""
    from portbench import spec

    if run.trace is None or run.calls is None:
        return None
    mod = spec.load_module("roofline", kernel)
    shapes = run.calls.shapes.get(kernel, [])
    device_s = run.trace.seconds_of(mod.KERNELS)
    if not shapes or device_s <= 0.0:
        return None
    least = sum(least_seconds(*mod.work(s)) for s in shapes)
    return 100.0 * least / device_s
