"""Scintirete on PyTorch and CUDA: the port of `scintirete_tpu` to NVIDIA
Hopper.

The JAX package `scintirete_tpu` stays the reference; this package keeps
its module names (`ops`, `index`, `engine`) so each counterpart is easy to
find. It imports `torch` and never `jax`, and nothing of the JAX package:
the jax-free modules it needs (`types`, `errors`, `config`,
`utils.rwlock`, `native.build` with its C++ source, the proto, the
audit log, metrics and embedding client) are copied into it.
The C++ link-application library is built with g++ into `build/native/`
and the CUDA kernels with nvcc into `build/kernels/`, both beside the
package, at first use.

Every index takes an explicit `device`: "cuda" by default, which raises
on a machine without CUDA (there is no fallback to the CPU). Pass
`device="cpu"` to run the plain torch versions of the kernels.

Float32 products run in true f32 (no TF32): the search's distances enter
its candidate lists and must match the reference's.
"""

import torch

__version__ = "0.1.0"

from scintirete_tpu_torch.errors import ScintireteError  # noqa: F401
from scintirete_tpu_torch.types import (  # noqa: F401
    CollectionConfig,
    DistanceMetric,
    HNSWParams,
    SearchParams,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
