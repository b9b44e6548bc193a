"""Shared synthetic-corpus generator for the benchmark harnesses.

Clustered corpus (mixture on the unit sphere): text embeddings cluster, and
IVF recall on a UNIFORM random corpus degenerates to ~nprobe/nlist by
construction, so a representative ANN benchmark must use clustered data.
CRITICAL (round-2 postmortem): noise must be scaled as a fraction of the
unit vector, not per-coordinate — per-coordinate sigma s yields a noise
vector of norm s*sqrt(D) that drowns the center and silently produces a
uniform corpus (recall@10 measured 0.13 == the degeneracy).

Used by bench.py (driver headline metrics) and scripts/bench_scale.py so
the generation bug class stays fixed in ONE place.
"""

from __future__ import annotations

import numpy as np


def on_sphere_noise(rng: np.random.Generator, base: np.ndarray,
                    radius: float) -> np.ndarray:
    """base (unit rows) perturbed by `radius` along a random unit direction,
    re-normalized: cos(out, base) ~ 1/sqrt(1+radius^2)."""
    g = rng.standard_normal(base.shape).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    out = base + radius * g
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def clustered_corpus(rng: np.random.Generator, n: int, d: int,
                     n_queries: int, *,
                     cluster_radius: float = 0.45,
                     query_radius: float = 0.35):
    """Returns (x [n, d], q [n_queries, d]) unit rows.

    Corpus: points around n/256 cluster centers at intra-cluster radius
    0.45 (cos ~ 0.91, typical same-topic sentence embeddings). Queries:
    perturbations of corpus points at radius 0.35 (cos ~ 0.94 — how real
    queries relate to their relevant documents)."""
    c = max(n // 256, 64)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = on_sphere_noise(rng, centers[rng.integers(c, size=n)], cluster_radius)
    qsrc = x[rng.choice(n, size=n_queries, replace=False)]
    return x, on_sphere_noise(rng, qsrc, query_radius)
