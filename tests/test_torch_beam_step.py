"""The layer-0 beam step's CUDA kernel (`ops/beam_step.py`,
`csrc/beam_step.cu`) against the plain torch step it replaces on a card.

On the card (marked `cuda`, skipped without one; no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_beam_step.py

- over whole beams on integer-valued vectors, where every summation order
  of the dot is exact, the kernel's state after each step equals the torch
  step's bit for bit: slots, distance bits, flags, `active` and the status
  [any active, steps, rows read]; the three metrics, D 48 / 100 / 128 /
  960, ef 10 / 50 / 128 / 200, expand 4 and 8, an f32 and a bf16 mirror,
  tombstones, -1 neighbours, duplicated and -1 / +inf padded entries and
  queries converged from the start;
- on float data the two give the same answers within the stated
  tolerance;
- a query's bits do not depend on the other rows of its batch;
- a list too long for one block's shared memory runs the same kernel from
  a global workspace, bit for bit against the torch step;
- the launch counter counts eager steps and graph replays, not captures.

On the CPU: the wrapper's checks, that CPU tensors take the plain step
and launch nothing, the replay count, the "dist_rows" count of the rows read, and the
benchmark's `beam.fused_share.batch` reader on a made-up run.
"""

import numpy as np
import pytest
import torch

from scintirete_tpu_torch.index import device as device_mod
from scintirete_tpu_torch.ops import beam_step as fused_step


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(device, metric, dim, ef, n=4000, degree=32, batch=64,
             dtype=torch.float32, seed=0, integer=True):
    """A layer-0 graph of n rows (-1 holes in its adjacency, 15% of the rows
    deleted), `batch` queries and their entry lists: a few entries each
    (one duplicated, one 1e-3 off its distance, as a pivot scan's entry
    may be), padded with (-1, +inf); the last 4 rows enter with nothing
    and are converged from the start. Integer-valued vectors make every
    dot exact in any summation order."""
    rng = np.random.default_rng(seed * 1000 + metric * 100 + dim + ef)
    if integer:
        vecs = rng.integers(-3, 4, (n, dim)).astype(np.float32)
        queries = rng.integers(-3, 4, (batch, dim)).astype(np.float32)
    else:
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        queries = rng.standard_normal((batch, dim)).astype(np.float32)
    vecs[rng.integers(0, n, 8)] = 0.0  # zero rows: cosine scores them 1
    nbrs = rng.integers(0, n, (n, degree))
    nbrs[rng.random((n, degree)) < 0.1] = -1
    deleted = rng.random(n) < 0.15
    vectors = torch.from_numpy(vecs).to(device, dtype)
    sq = torch.from_numpy((vecs * vecs).sum(1)).to(device)
    dist_to = device_mod._make_dist_fn(torch.from_numpy(queries).to(device),
                                       vectors, sq, metric)
    entries = rng.integers(0, n, (batch, 3))
    entries[:, 1] = entries[:, 0]
    ent = torch.from_numpy(entries).to(device)
    ent = torch.where(torch.from_numpy(deleted).to(device)[ent], -1, ent)
    ent_d = torch.where(ent >= 0, dist_to(ent.clamp(min=0)), torch.inf)
    ent_d[:, 2] += 1e-3
    ent[-4:], ent_d[-4:] = -1, torch.inf
    pad = ef - 3
    cand_s = torch.cat([ent, ent.new_full((batch, pad), -1)], 1)
    cand_d = torch.cat([ent_d, ent_d.new_full((batch, pad), torch.inf)], 1)
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    return (dist_to, torch.from_numpy(nbrs).to(device),
            torch.from_numpy(deleted).to(device), cand_s.gather(1, order),
            cand_d)


def _beams(dist_to, nbrs, deleted, cand_s, cand_d, expand):
    """The same beam twice: the kernel's, and the torch step's on the same
    device."""
    fused = device_mod._Layer0Beam(dist_to, nbrs, deleted, cand_s.clone(),
                                   cand_d.clone(), expand)
    plain = device_mod._Layer0Beam(dist_to, nbrs, deleted, cand_s.clone(),
                                   cand_d.clone(), expand)
    plain.fused = False
    return fused, plain


def _state(beam):
    return (beam.cand_s, beam.cand_d.view(torch.int32), beam.expanded,
            beam.active, beam.status)


CASES = [(48, 10, 4), (100, 50, 4), (128, 128, 8), (960, 50, 4),
         (100, 200, 8), (128, 50, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("dim,ef,expand", CASES)
def test_kernel_step_equals_the_torch_step(dev, metric, dim, ef, expand):
    """Every step of a whole beam, bit for bit, until both converge."""
    fused, plain = _beams(*_problem(dev, metric, dim, ef), expand)
    assert fused.fused
    before = fused_step.beam_step.launches
    steps = 0
    while bool(plain.active.any()) and steps < ef + 64:
        fused.step()
        plain.step()
        steps += 1
        for name, k, p in zip(("slots", "dists", "flags", "active", "status"),
                              _state(fused), _state(plain)):
            assert torch.equal(k, p), (name, steps)
    torch.cuda.synchronize()
    assert steps > 3 and not bool(fused.active.any())
    assert fused_step.beam_step.launches == before + steps
    status = fused.status.tolist()
    assert status[1] == steps and status[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("dim", [100, 960])
def test_kernel_step_on_a_bf16_mirror(dev, metric, dim):
    """A bf16 mirror (rows widened to f32 in the kernel, `.float()` in the
    torch step): bit for bit on integer values, which bf16 holds exactly."""
    fused, plain = _beams(*_problem(dev, metric, dim, 50,
                                    dtype=torch.bfloat16), 4)
    assert fused.fused
    for _ in range(20):
        fused.step()
        plain.step()
        for k, p in zip(_state(fused), _state(plain)):
            assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [33, 101])
def test_kernel_step_at_a_ragged_width(dev, dim):
    """D not a multiple of the 16-byte chunk: the scalar loads' path."""
    fused, plain = _beams(*_problem(dev, 1, dim, 50), 4)
    for _ in range(20):
        fused.step()
        plain.step()
        for k, p in zip(_state(fused), _state(plain)):
            assert torch.equal(k, p)


def _run_beam(beam, max_steps=200):
    steps = 0
    while bool(beam.active.any()) and steps < max_steps:
        beam.step()
        steps += 1
    return beam.cand_s.clone(), beam.cand_d.clone(), steps


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("dim", [100, 960])
def test_kernel_answers_on_float_data(dev, metric, dim):
    """Gaussian rows: the dot's summation order differs from torch's `.sum`
    (a fixed tree over 16-byte chunks against torch's reduction), and a
    reordered f32 sum of D terms differs by about sqrt(D) ulp of the
    terms' magnitude, far under 2e-5 of S = sum |x_i q_i|. So each
    distance is held within 2e-5 of what S moves it by: 2 S for L2, S for
    IP and S / (|q| |x|) for cosine (~2e-5 in distance). A kernel that
    dropped one 16-byte chunk of a row would be off by ~4 / D of S, 10
    times that bound or more. Such a difference can swap two near-equal
    candidates and so steer a beam elsewhere, so the final lists are
    compared as sets: at least 99% of their slots in common, and each
    common slot's two distances within that tolerance."""
    dist_to = _problem(dev, metric, dim, 50, integer=False)[0]
    fused, plain = _beams(*_problem(dev, metric, dim, 50, integer=False), 4)
    fs, fd, _ = _run_beam(fused)
    ps, pd, _ = _run_beam(plain)
    vecs, q = dist_to.vectors.float(), dist_to.q32
    common = total = 0
    for b in range(fs.shape[0]):
        kd = {s: d for s, d in zip(fs[b].tolist(), fd[b].tolist()) if s >= 0}
        pdd = {s: d for s, d in zip(ps[b].tolist(), pd[b].tolist()) if s >= 0}
        both = sorted(kd.keys() & pdd.keys())
        common += len(both)
        total += max(len(kd), len(pdd))
        if not both:
            continue
        x = vecs[torch.tensor(both, device=dev)]
        scale = (x * q[b]).abs().sum(1)
        if metric == 1:
            scale = 2 * scale
        elif metric == 2:
            scale = scale / (x.norm(dim=1) * q[b].norm()).clamp(min=1e-30)
        gap = torch.tensor([abs(kd[s] - pdd[s]) for s in both], device=dev)
        assert bool((gap <= 2e-5 * scale).all()), (b, (gap / scale).max())
    assert total > 0 and common >= 0.99 * total


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [1, 2, 3])
@pytest.mark.parametrize("rows", [[0], [5, 6], list(range(17))])
def test_kernel_bits_do_not_depend_on_the_batch(dev, metric, rows):
    """Float data: some queries alone end their beams with the same slots
    and distance bits as inside the batch of 64."""
    dist_to, nbrs, deleted, cand_s, cand_d = _problem(
        dev, metric, 128, 50, integer=False)
    full = device_mod._Layer0Beam(dist_to, nbrs, deleted, cand_s.clone(),
                                  cand_d.clone(), 4)
    fs, fd, _ = _run_beam(full)
    r = torch.tensor(rows, device=dev)
    part_to = device_mod._DistTo(dist_to.q32[r].contiguous(), dist_to.q_sq[r],
                                 dist_to.q_norm[r], dist_to.vectors,
                                 dist_to.sq_norms, metric)
    part = device_mod._Layer0Beam(part_to, nbrs, deleted, cand_s[r].clone(),
                                  cand_d[r].clone(), 4)
    ps, pd, _ = _run_beam(part)
    assert torch.equal(ps, fs[r])
    assert torch.equal(pd.view(torch.int32), fd[r].view(torch.int32))


@pytest.mark.cuda
def test_a_list_too_long_for_shared_memory_runs_from_a_workspace(dev):
    """ef 20,000 + 4 x 32 entries do not fit 227 KB of shared memory: the
    beam still runs the kernel, from a global workspace, one launch and
    one fused step a step, and answers as the torch step on the CPU
    (integer data), bit for bit."""
    ef = 20000
    assert fused_step.workspace(8, ef // 4, 4, 32, 48, torch.float32,
                                dev) is None
    work = fused_step.workspace(8, ef, 4, 32, 48, torch.float32, dev)
    assert work is not None and work.numel() > 8 * fused_step.SMEM_MAX
    dist_to, nbrs, deleted, cand_s, cand_d = _problem(dev, 1, 48, ef,
                                                      batch=8)
    before = fused_step.beam_step.launches
    got = device_mod._ef_beam_layer0(dist_to, nbrs, deleted, cand_s, cand_d,
                                     ef, 30, block=4)
    assert got[2] > 0 and got[3]["fused_steps"] == got[2]
    assert fused_step.beam_step.launches - before >= got[2]
    cpu = device_mod._DistTo(*(t.cpu() for t in (
        dist_to.q32, dist_to.q_sq, dist_to.q_norm, dist_to.vectors,
        dist_to.sq_norms)), 1)
    want = device_mod._ef_beam_layer0(cpu, nbrs.cpu(), deleted.cpu(),
                                      cand_s.cpu(), cand_d.cpu(), ef, 30,
                                      block=4)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].view(torch.int32))
    assert got[2] == want[2]
    assert got[3]["dist_rows"] == want[3]["dist_rows"]


@pytest.mark.cuda
def test_search_counts_fused_steps_on_the_card(dev):
    """Through DeviceIndex on a card: every layer-0 step is the kernel's,
    graphed, and "dist_rows" counts no more than the steps' rows."""
    from scintirete_tpu_torch import DistanceMetric, HNSWParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex

    rng = np.random.default_rng(5)
    base = rng.standard_normal((5000, 48)).astype(np.float32)
    idx = HNSWIndex(48, HNSWParams(m=16, ef_construction=100, seed=3),
                    DistanceMetric.L2, device=dev)
    idx.bulk_insert(list(range(1, 5001)), base)
    dev_idx = idx._get_device()
    before = dict(dev_idx.steps)
    launches = fused_step.beam_step.launches
    dev_idx.search(idx.store, base[:200], 10, 50)
    torch.cuda.synchronize()
    grew = {k: dev_idx.steps[k] - before[k] for k in before}
    assert grew["layer0"] > 0
    assert grew["fused_steps"] == grew["graph_steps"] == grew["layer0"]
    assert 0 < grew["dist_rows"] <= grew["layer0"] * 200 * 4 * 32
    # a launch a replay (at most BEAM_BLOCK - 1 past convergence a
    # sub-batch) and a warm-up step a capture; the capture launches nothing
    launched = fused_step.beam_step.launches - launches - grew["graph_captures"]
    assert grew["layer0"] <= launched
    assert launched < grew["layer0"] + device_mod.BEAM_BLOCK * grew["batches"]


# --- on the CPU ---------------------------------------------------------


def _wrapper_args(B=3, ef=8, cap=20, D=6, degree=4):
    f = torch.float32
    return dict(
        q32=torch.zeros(B, D), q_sq=torch.zeros(B), q_norm=torch.zeros(B),
        vectors=torch.zeros(cap, D), sq_norms=torch.zeros(cap),
        deleted=torch.zeros(cap, dtype=torch.bool),
        neighbors0=torch.zeros(cap, degree, dtype=torch.int64),
        cand_s=torch.zeros(B, ef, dtype=torch.int64),
        cand_d=torch.zeros(B, ef, dtype=f),
        expanded=torch.zeros(B, ef, dtype=torch.bool),
        active=torch.zeros(B, dtype=torch.bool),
        status=torch.zeros(3, dtype=torch.int64),
        scratch=torch.zeros(3, dtype=torch.int64), work=None, metric=1,
        expand=4,
    )


@pytest.mark.parametrize("name,bad,match", [
    ("q32", torch.zeros(3, 6, dtype=torch.float64), "q32"),
    ("q_sq", torch.zeros(4), "q_sq"),
    ("vectors", torch.zeros(20, 6, dtype=torch.float16), "float32 or bfloat16"),
    ("deleted", torch.zeros(20, dtype=torch.uint8), "deleted"),
    ("neighbors0", torch.zeros(20, 4, dtype=torch.int32), "neighbors0"),
    ("cand_s", torch.zeros(3, 8, dtype=torch.int32), "cand_s"),
    ("cand_d", torch.zeros(8, 3).T, "contiguous"),
    ("expanded", torch.zeros(3, 7, dtype=torch.bool), "expanded"),
    ("active", torch.zeros(3), "active"),
    ("status", torch.zeros(2, dtype=torch.int64), "status"),
    ("scratch", torch.zeros(3, dtype=torch.int32), "scratch"),
    ("work", torch.zeros(64), "work"),
    ("work", torch.zeros(2, 32, dtype=torch.uint8), "work"),
    ("metric", 7, "metric"),
    ("expand", 9, "expand"),
    ("expand", 0, "expand"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(name, bad, match):
    args = _wrapper_args()
    args[name] = bad
    with pytest.raises(ValueError, match=match):
        fused_step.beam_step(**args)


def test_wrapper_needs_cuda_tensors():
    """Valid CPU tensors: the wrapper raises (the torch step is the CPU's,
    chosen by `_Layer0Beam`, never by a fallback inside the wrapper)."""
    before = fused_step.beam_step.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_step.beam_step(**_wrapper_args())
    assert fused_step.beam_step.launches == before


def test_replays_count_as_launches():
    """A captured step launches nothing when captured; its replays are
    counted as launches by the loop that replays it."""
    before = fused_step.beam_step.launches
    fused_step.replayed(5)
    assert fused_step.beam_step.launches == before + 5


def test_cpu_search_takes_the_plain_step():
    """An HNSW search on CPU tensors: no kernel launch, no fused step, every
    layer-0 beam the torch step's."""
    from scintirete_tpu_torch import DistanceMetric, HNSWParams
    from scintirete_tpu_torch.index.hnsw import HNSWIndex

    rng = np.random.default_rng(2)
    base = rng.standard_normal((600, 16)).astype(np.float32)
    idx = HNSWIndex(16, HNSWParams(m=8, ef_construction=64, seed=1),
                    DistanceMetric.COSINE, device="cpu")
    idx.bulk_insert(list(range(1, 601)), base)
    dev_idx = idx._get_device()
    before = dict(dev_idx.steps)
    launches = fused_step.beam_step.launches
    dev_idx.search(idx.store, base[:40], 10, 32)
    grew = {k: dev_idx.steps[k] - before[k] for k in before}
    assert fused_step.beam_step.launches == launches
    assert grew["layer0"] > 0 and grew["fused_steps"] == 0
    assert grew["graph_steps"] == 0 and grew["dist_rows"] > 0


def test_dist_rows_count_the_rows_read():
    """A hand-made graph: query 0 active and expanding slots 0 and 1,
    query 1 converged from the start. Slot 0's neighbours are 2, -1, 3 and
    4 (4 deleted), slot 1's are 5, -1, -1, 2: the step reads rows 2, 3, 5
    and 2 again, four rows; the converged query reads none, though the
    torch step scores (and masks) 2 x 4 candidates for each query."""
    vecs = torch.arange(8 * 2, dtype=torch.float32).reshape(8, 2)
    deleted = torch.zeros(8, dtype=torch.bool)
    deleted[4] = True
    nbrs = torch.full((8, 4), -1, dtype=torch.int64)
    nbrs[0] = torch.tensor([2, -1, 3, 4])
    nbrs[1] = torch.tensor([5, -1, -1, 2])
    q = torch.tensor([[0.5, 0.5], [9.0, 9.0]])
    dist_to = device_mod._make_dist_fn(q, vecs, (vecs * vecs).sum(1), 1)
    inf = float("inf")
    cand_s = torch.tensor([[0, 1, -1, -1, -1], [-1, -1, -1, -1, -1]])
    cand_d = torch.tensor([[0.5, 8.5, inf, inf, inf], [inf] * 5])
    beam = device_mod._Layer0Beam(dist_to, nbrs, deleted, cand_s, cand_d, 2)
    assert beam.active.tolist() == [True, False] and not beam.fused
    beam.step()
    assert beam.status.tolist()[1:] == [1, 4]
    assert set(beam.cand_s[0].tolist()) == {0, 1, 2, 3, 5}
    while bool(beam.active.any()):
        beam.step()
    steps, rows = beam.status.tolist()[1:]
    assert steps >= 2 and rows >= 4
    beam.step()  # past convergence: reads nothing, counts nothing
    assert beam.status.tolist() == [0, steps, rows]


def _fake_run(before, after):
    import types

    return types.SimpleNamespace(counters={"steps": (before, after)})


def test_fused_share_reader():
    """`beam.fused_share.batch`: fused over layer-0 steps of the window, in
    %; None where the program has no such counter or ran no step."""
    from portbench import spec

    def read(run):
        return spec.read_metric("layer_metrics",
                                {"name": "beam.fused_share.batch"}, run)

    before = {"layer0": 100, "fused_steps": 100, "graph_steps": 100}
    after = {"layer0": 300, "fused_steps": 250, "graph_steps": 300}
    assert read(_fake_run(before, after)) == pytest.approx(75.0)
    assert read(_fake_run(before, dict(after, fused_steps=300))) == 100.0
    old = {"layer0": 100, "graph_steps": 100}
    assert read(_fake_run(old, dict(old, layer0=300))) is None
    assert read(_fake_run(before, before)) is None
    import types

    assert read(types.SimpleNamespace(counters={"steps": None})) is None
    assert read(types.SimpleNamespace(counters={})) is None
