"""The benchmark's data, made from the seed (numpy only).

Workload v2, as `chip_smoke.py` and `bench.py` make it, with the size and
the width as parameters: centres drawn from N(0, 1) x `centre_scale`, base
points a centre plus N(0, 1) x `point_noise`, queries a base point plus
N(0, 1) x `query_noise`. Each part draws from a stream of its own
(`numpy.random.default_rng([seed, stream])`) in chunks of a fixed size, so
the same seed gives the same arrays whatever else is generated.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CENTRES, BASE, QUERIES = range(3)
CHUNK = 1 << 16


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclasses.dataclass
class Data:
    centres: np.ndarray  # [C, D] f32
    base: np.ndarray  # [N, D] f32
    queries: np.ndarray  # [Q, D] f32


def centres(seed: int, n: int, dim: int, scale: float) -> np.ndarray:
    r = rng(seed, CENTRES)
    return (r.standard_normal((n, dim), dtype=np.float32) * np.float32(scale))


def points_near(r: np.random.Generator, cent: np.ndarray, n: int,
                noise: float) -> np.ndarray:
    out = np.empty((n, cent.shape[1]), np.float32)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        assign = r.integers(0, len(cent), e - s)
        out[s:e] = cent[assign]
        out[s:e] += r.standard_normal((e - s, cent.shape[1]),
                                      dtype=np.float32) * np.float32(noise)
    return out


def perturbed(r: np.random.Generator, points: np.ndarray, n: int,
              noise: float) -> np.ndarray:
    idx = r.integers(0, len(points), n)
    return points[idx] + r.standard_normal(
        (n, points.shape[1]), dtype=np.float32) * np.float32(noise)


def dataset(seed: int, data: dict) -> Data:
    """`data` is a configuration's `data` section: n, dim, queries,
    centres, centre_scale, point_noise, query_noise."""
    cent = centres(seed, data["centres"], data["dim"], data["centre_scale"])
    base = points_near(rng(seed, BASE), cent, data["n"], data["point_noise"])
    queries = perturbed(rng(seed, QUERIES), base, data["queries"],
                        data["query_noise"])
    return Data(cent, base, queries)

