"""Generated protobuf bindings (protoc --python_out of scintirete.proto).

Byte-identical copies of `scintirete_tpu/proto/`: both modules register
`scintirete.proto` in protobuf's default descriptor pool, which accepts a
second registration only if its serialized descriptor is the same bytes.
So never regenerate one of them alone, and keep the proto package name.
"""

from scintirete_tpu_torch.proto import scintirete_pb2  # noqa: F401
