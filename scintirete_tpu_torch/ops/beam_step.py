"""The search's layer-0 beam step as one CUDA kernel (`csrc/beam_step.cu`).

One launch advances every query row of the beam's lists by one step, in
place: the `expand` nearest unexpanded entries of an active query are
expanded, their live neighbours scored, the lists deduplicated and merged,
and then the convergence test gives the next `active` and the status
[any active, steps, rows read] (`index/device.py` `_Layer0Beam`).

Its plain version is the torch step of `index/device.py` (`_beam_step`,
`_beam_converged` and the status update of `_Layer0Beam.step`), which
`_Layer0Beam` takes for CPU tensors. For CUDA tensors `beam_step` launches
or raises. A list too long for one block's shared memory runs the same
kernel from a global workspace (`workspace`). Given the same distances
the two agree bit for bit; the dot's summation order is the kernel's own,
fixed by D (the rounding after it is `_cmp_dist`'s).

`beam_step.launches` counts the kernel's launches: each eager call, and
each replay of a captured step (`replayed`); a capture launches nothing.
"""

from __future__ import annotations

import torch

from scintirete_tpu_torch.types import DistanceMetric

_METRICS = (int(DistanceMetric.L2), int(DistanceMetric.COSINE),
            int(DistanceMetric.INNER_PRODUCT))
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# the most shared memory one block may use on an H100 (227 KB)
SMEM_MAX = 232448
# slots are packed as (slot + 1) << 1 | flag in 32 bits
_MAX_ROWS = 2**31 - 2


def _layout_bytes(ef: int, expand: int, degree: int, dim: int, dtype) -> int:
    """Bytes of one block's layout for a step of this shape (the kernel's
    own count). Builds and loads the kernels."""
    from scintirete_tpu_torch.ops._ext import kernel

    nbytes = kernel("beam_step_smem")(ef, expand, degree, dim, _ELEM_BYTES[dtype])
    if nbytes < 0:
        raise ValueError(f"beam_step: no step of ef {ef}, expand {expand}, "
                         f"degree {degree}, D {dim}")
    return nbytes


def workspace(B: int, ef: int, expand: int, degree: int, dim: int, dtype,
              device) -> torch.Tensor | None:
    """None where a step of this shape keeps its layout in one block's
    shared memory, else the global workspace `beam_step` then takes: B
    slices of the layout's bytes, uint8."""
    nbytes = _layout_bytes(ef, expand, degree, dim, dtype)
    if nbytes <= SMEM_MAX:
        return None
    return torch.empty(B * nbytes, dtype=torch.uint8, device=device)


def beam_step(q32, q_sq, q_norm, vectors, sq_norms, deleted, neighbors0,
              cand_s, cand_d, expanded, active, status, scratch, work,
              metric: int, expand: int) -> None:
    """One layer-0 step of every row of cand_s i64 / cand_d f32 / expanded
    bool [B, ef] under active bool [B], in place, then `active` and status
    i64 [3] as `_Layer0Beam.step` leaves them. q32 [B, D] f32 with q_sq and
    q_norm [B] f32; vectors [cap, D] f32 or bf16, sq_norms [cap] f32,
    deleted [cap] bool, neighbors0 [cap, degree] i64; scratch [3] i64, zero
    before the first step (each step leaves it zero); work: `workspace`'s
    tensor for this shape, None where it gives None."""
    B, ef = cand_s.shape
    cap, D = vectors.shape
    degree = neighbors0.shape[1]
    dev = cand_s.device
    from scintirete_tpu_torch.ops._ext import check_tensor as _check

    _check(q32, "q32", torch.float32, (B, D), dev)
    _check(q_sq, "q_sq", torch.float32, (B,), dev)
    _check(q_norm, "q_norm", torch.float32, (B,), dev)
    if vectors.dtype not in _ELEM_BYTES:
        raise ValueError(f"vectors: want float32 or bfloat16, got {vectors.dtype}")
    _check(vectors, "vectors", vectors.dtype, (cap, D), dev)
    _check(sq_norms, "sq_norms", torch.float32, (cap,), dev)
    _check(deleted, "deleted", torch.bool, (cap,), dev)
    _check(neighbors0, "neighbors0", torch.int64, (cap, degree), dev)
    _check(cand_s, "cand_s", torch.int64, (B, ef), dev)
    _check(cand_d, "cand_d", torch.float32, (B, ef), dev)
    _check(expanded, "expanded", torch.bool, (B, ef), dev)
    _check(active, "active", torch.bool, (B,), dev)
    _check(status, "status", torch.int64, (3,), dev)
    _check(scratch, "scratch", torch.int64, (3,), dev)
    if work is not None and (work.dtype != torch.uint8 or work.dim() != 1
                             or work.device != dev
                             or not work.is_contiguous()):
        raise ValueError("work: want a contiguous 1-D uint8 tensor on "
                         f"{dev}, got {work.dtype} {tuple(work.shape)} on "
                         f"{work.device}")
    if metric not in _METRICS:
        raise ValueError(f"unsupported metric code: {metric}")
    if not 1 <= expand <= ef:
        raise ValueError(f"expand must be in [1, ef = {ef}], got {expand}")
    if cap > _MAX_ROWS:
        raise ValueError(f"vectors: at most {_MAX_ROWS} rows, got {cap}")
    if dev.type != "cuda":
        raise ValueError(f"beam_step: needs CUDA tensors, got {dev}")
    nbytes = _layout_bytes(ef, expand, degree, D, vectors.dtype)
    want = None if nbytes <= SMEM_MAX else B * nbytes
    if (None if work is None else work.numel()) != want:
        raise ValueError(f"work: want {want} bytes for this shape, got "
                         f"{None if work is None else work.numel()}")
    from scintirete_tpu_torch.ops._ext import kernel

    err = kernel("beam_step")(
        q32.data_ptr(), q_sq.data_ptr(), q_norm.data_ptr(), vectors.data_ptr(),
        sq_norms.data_ptr(), deleted.data_ptr(), neighbors0.data_ptr(),
        cand_s.data_ptr(), cand_d.data_ptr(), expanded.data_ptr(),
        active.data_ptr(), status.data_ptr(), scratch.data_ptr(),
        None if work is None else work.data_ptr(), B, ef, expand, degree, D, metric, _ELEM_BYTES[vectors.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"beam_step launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        beam_step.launches += 1


beam_step.launches = 0


def replayed(n: int) -> None:
    """Counts `n` replays of a captured step: one launch each."""
    beam_step.launches += n
