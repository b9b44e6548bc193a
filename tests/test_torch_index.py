"""The port's FlatIndex against the JAX package's FlatIndex(backend="xla").

Same upserts, deletes, compactions and growth on both; same ids back. An
index saved by either package loads in the other and answers the same.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from financial_rag_tpu.index.flat import FlatIndex as JaxFlatIndex
from financial_rag_tpu_torch.index import pending
from financial_rag_tpu_torch.index.flat import FlatIndex

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _unit(rng, n, d=64):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(dtype, capacity=1024):
    jdt, tdt = DTYPES[dtype]
    return (JaxFlatIndex(dim=64, capacity=capacity, dtype=jdt, backend="xla"),
            FlatIndex(dim=64, capacity=capacity, dtype=tdt, device="cpu"))


def _assert_same_search(jidx, tidx, queries, k=16):
    j_ids, j_sc = jidx.search(queries, k)
    t_ids, t_sc = tidx.search(queries, k)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_mutations_match_jax(dtype):
    rng = np.random.default_rng(0)
    jidx, tidx = _pair(dtype)
    assert tidx.backend == "xla"
    queries = _unit(rng, 5)
    ids = np.arange(1, 901, dtype=np.int64) * 7
    vecs = _unit(rng, 900)
    for idx in (jidx, tidx):
        idx.upsert(ids, vecs)
    _assert_same_search(jidx, tidx, queries)

    # grow past the first tile, overwrite some, delete some, compact
    more_ids = np.arange(1000, 1600, dtype=np.int64) * 7
    more = _unit(rng, 600)
    over = _unit(rng, 50)
    for idx in (jidx, tidx):
        idx.upsert(more_ids, more)
        idx.upsert(ids[:50], over)
    assert tidx.capacity == jidx.capacity == 2048
    _assert_same_search(jidx, tidx, queries)
    dead = ids[100:400]
    assert jidx.delete(dead) == tidx.delete(dead) == 300
    _assert_same_search(jidx, tidx, queries)
    assert jidx.compact() == tidx.compact() == 300
    assert jidx.count() == tidx.count() == 1200
    _assert_same_search(jidx, tidx, queries)
    # the stored vectors themselves agree after compaction
    np.testing.assert_allclose(tidx._vectors[:1200].float().numpy(),
                               np.asarray(jidx._vectors[:1200], np.float32), atol=0)


def test_device_tensor_upsert_and_query():
    rng = np.random.default_rng(1)
    jidx, tidx = _pair("float32")
    vecs = _unit(rng, 300) * 3.0                   # unnormalized on purpose
    ids = np.arange(10, 310, dtype=np.int64)
    jidx.upsert(ids, jnp.asarray(vecs))
    tidx.upsert(ids, torch.from_numpy(vecs))
    q = _unit(rng, 4)
    _assert_same_search(jidx, tidx, q)
    np.testing.assert_array_equal(tidx.search(torch.from_numpy(q), 8)[0], tidx.search(q, 8)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_saved_index_loads_across_packages(tmp_path, dtype):
    rng = np.random.default_rng(2)
    jdt, tdt = {"int8": (jnp.int8, torch.int8)}.get(dtype) or DTYPES[dtype]
    jidx = JaxFlatIndex(dim=64, capacity=1024, dtype=jdt, backend="xla", name="c")
    tidx = FlatIndex(dim=64, capacity=1024, dtype=tdt, device="cpu", name="c")
    ids = np.arange(1, 501, dtype=np.int64)
    vecs = _unit(rng, 500)
    for idx in (jidx, tidx):
        idx.upsert(ids, vecs)
        idx.delete(ids[::9])
    q = _unit(rng, 6)
    _assert_same_search(jidx, tidx, q)

    jidx.save(tmp_path / "from_jax")
    tidx.save(tmp_path / "from_port")
    port_loaded = FlatIndex.load(tmp_path / "from_jax", name="c", device="cpu")
    jax_loaded = JaxFlatIndex.load(tmp_path / "from_port", name="c", backend="xla")
    assert port_loaded.dtype == tdt and port_loaded.count() == jidx.count()
    _assert_same_search(jidx, port_loaded, q)
    _assert_same_search(jax_loaded, tidx, q)


@pytest.mark.parametrize("backend,dtype", [("pallas_fused", "int8"),
                                           ("pallas_bucketed", "bfloat16"),
                                           ("pallas_bucketed", "int8"),
                                           ("pallas_exact", "float32"),
                                           ("pallas_exact", "int8")])
def test_kernel_backends_match_the_jax_exact_index(backend, dtype):
    """The int8 fused sweep (K5), the bucketed (K7) and the exact (K6)
    backends, through their CPU plain versions: on a corpus that fits the
    buckets every backend is exact, so ids equal the JAX package's xla
    index; after growth past 4,096 slots the bucketed ones stay near-exact."""
    rng = np.random.default_rng(5)
    jdt, tdt = {"int8": (jnp.int8, torch.int8)}.get(dtype) or DTYPES[dtype]
    jidx = JaxFlatIndex(dim=64, capacity=1024, dtype=jdt, backend="xla")
    tidx = FlatIndex(dim=64, capacity=1024, dtype=tdt, backend=backend, device="cpu")
    ids = np.arange(1, 1801, dtype=np.int64)
    vecs = _unit(rng, 1800)
    for idx in (jidx, tidx):
        idx.upsert(ids, vecs)
        idx.delete(ids[::11])
    q = _unit(rng, 5)
    _assert_same_search(jidx, tidx, q)
    more, more_vecs = np.arange(5000, 8000, dtype=np.int64), _unit(rng, 3000)
    for idx in (jidx, tidx):
        idx.upsert(more, more_vecs)
    assert tidx.capacity == 8192
    j_ids, _ = jidx.search(q, 16)
    t_ids, _ = tidx.search(q, 16)
    overlap = np.mean([len(set(a) & set(b)) / 16 for a, b in zip(j_ids.tolist(), t_ids.tolist())])
    assert overlap >= (1.0 if backend == "pallas_exact" else 0.9)


def test_packed_backend_on_cpu_matches_exact_on_small_corpus():
    """With one tile (N <= 1024) every column is its own bucket: the packed
    sweep's ids equal the exact sweep's."""
    rng = np.random.default_rng(3)
    exact = FlatIndex(dim=64, capacity=1024, dtype=torch.float32, device="cpu")
    packed = FlatIndex(dim=64, capacity=1024, dtype=torch.float32, device="cpu",
                       backend="pallas_fused")
    ids = np.arange(1, 801, dtype=np.int64)
    vecs = _unit(rng, 800)
    for idx in (exact, packed):
        idx.upsert(ids, vecs)
    q = _unit(rng, 5)
    np.testing.assert_array_equal(packed.search(q, 24)[0], exact.search(q, 24)[0])


def test_collect_fetches_many_pendings_at_once():
    rng = np.random.default_rng(4)
    a = FlatIndex(dim=64, capacity=1024, device="cpu", name="a")
    b = FlatIndex(dim=64, capacity=1024, device="cpu", name="b")
    a.upsert(np.arange(1, 101), _unit(rng, 100))
    q = _unit(rng, 3)
    extra = torch.from_numpy(q)
    results, extra_host = pending.collect([a.search_begin(q, 5), b.search_begin(q, 5)],
                                          extra=[extra])
    np.testing.assert_array_equal(results[0][0], a.search(q, 5)[0])
    assert (results[1][0] == 0).all() and np.isneginf(results[1][1]).all()
    np.testing.assert_array_equal(extra_host[0], q)
