"""What the benchmark loads: never JAX or the JAX package (whole
top-level names: `scintirete_tpu_torch` begins with `scintirete_tpu`);
the reference and the client processes load nothing of the program."""

import json
import subprocess
import sys

from portbench.spec import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "scintirete_tpu"}


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import torch, numpy as np\n"
        "from portbench.reference import exact, control\n"
        "q = torch.randn(5, 8); b = torch.randn(50, 8)\n"
        "exact.answer_distances(q, exact.exact_topk(q, b, 'cosine', 3), b, 'cosine')\n"
        "c = control.ControlCollection('c', 8, 'l2', 'cpu', 'tf32-select')\n"
        "c.insert([(r, None) for r in np.ones((4, 8), np.float32)])\n"
        "c.search_batch(np.ones((2, 8), np.float32), type('P', (), {'top_k': 2}))\n")
    assert not mods & FORBIDDEN
    assert "scintirete_tpu_torch" not in mods


def test_client_side_loads_neither_torch_nor_the_program():
    mods = _modules_after(
        "from portbench import client, wire\n"
        "for d in ('open_search', 'closed_batch_search'):\n"
        "    client.load_driver(d)\n")
    assert not mods & (FORBIDDEN | {"torch", "scintirete_tpu_torch"})


def test_a_whole_run_loads_no_jax():
    mods = _modules_after(
        "from portbench.tests import tiny\n"
        "res = tiny.run('sift1m-flat.batch', seconds=1.0)\n"
        "assert res['correct'], res\n")
    assert not mods & FORBIDDEN
    assert "scintirete_tpu_torch" in mods


def test_run_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sift1m-flat.batch",
         "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
