"""Scintirete on PyTorch and CUDA: the port of `scintirete_tpu` to NVIDIA
Hopper.

The JAX package `scintirete_tpu` stays the reference; this package keeps
its module names (`ops`, `index`, `engine`) so each counterpart is easy to
find. It imports `torch` and never `jax`. From the JAX package it uses only
the jax-free modules `types`, `errors`, `config`, `utils.rwlock` and
`native.build`.

Every index takes an explicit `device`: "cuda" by default, which raises
on a machine without CUDA (there is no fallback to the CPU). Pass
`device="cpu"` to run the plain torch versions of the kernels.

Float32 products run in true f32 (no TF32): the search's distances enter
its candidate lists and must match the reference's.
"""

import torch

from scintirete_tpu.errors import ScintireteError  # noqa: F401
from scintirete_tpu.types import (  # noqa: F401
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
