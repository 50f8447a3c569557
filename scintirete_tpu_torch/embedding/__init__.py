"""OpenAI-compatible text-embedding client. A copy of
`scintirete_tpu/embedding/`."""

from scintirete_tpu_torch.embedding.client import EmbeddingClient, RateCounter  # noqa: F401
