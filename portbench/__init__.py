"""portbench: the benchmark of `scintirete_tpu_torch` (the PyTorch / CUDA
port) on one NVIDIA H100, served over gRPC.

One command runs one cell (a configuration under a traffic mix) for one
seed:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository root names the cells and metrics. Every
configuration, traffic mix, metric, roofline count and correctness limit
is a file of its own under this folder, found by the name that
`BENCHMARK.json` gives it (see `spec.py`).

This package imports neither torch nor the port at import time: its client
processes (`client.py`, `drivers/`) import only numpy, grpc and the frozen
proto copy in `proto/`. Nothing here imports JAX or the JAX package.
"""
