"""The port's multi-device serving path against the JAX package's.

The port holds one process over a device list (``parallel.mesh.search_devices``:
``n`` times ``cpu`` here); the JAX objects run on the 8 virtual CPU devices
of ``tests/conftest.py``. Every input is made from seeded numpy. Covered:
the device layouts, ``ShardedFlatIndex`` (the exact plain sweep, and K7's
plain version per shard against JAX's own ``bucketed_topk`` in interpret
mode), ``ShardedIVFIndex``, checkpoints both ways, data-parallel encode, the
runtime's sharded configurations, and mutation under concurrency.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
from financial_rag_tpu.index.flat import FlatIndex as JaxFlatIndex
from financial_rag_tpu.ops.topk import bucketed_topk as jax_bucketed_topk
from financial_rag_tpu.parallel.mesh import search_mesh
from financial_rag_tpu.parallel.sharded_index import ShardedFlatIndex as JaxShardedFlat
from financial_rag_tpu.parallel.sharded_ivf import ShardedIVFIndex as JaxShardedIVF
from financial_rag_tpu.runtime import _encode_mesh
from financial_rag_tpu_torch.config import FrameworkConfig
from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.parallel import (ShardedFlatIndex, ShardedIVFIndex, encode_devices,
                                              search_devices)
from financial_rag_tpu_torch.parallel import mesh as mesh_mod
from financial_rag_tpu_torch.runtime import Runtime

torch.set_num_threads(2)

D = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


# ------------------------------------------------------------ device layout


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_search_devices_take_search_meshs_count(eight_devices, n):
    assert len(search_devices(n, "cpu")) == search_mesh(n_shards=n).shape["shard"] == n
    assert search_devices(n, "cpu") == [torch.device("cpu")] * n


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_encode_devices_follow_the_encode_mesh_rule(eight_devices, n):
    cfg = JaxFrameworkConfig()
    cfg.mesh.encode_dp = n
    mesh = _encode_mesh(cfg)
    got = encode_devices(n, "cpu")
    assert (None if got is None else len(got)) == (None if mesh is None else mesh.size)


@pytest.mark.parametrize("count,want", [(1, [0, 0, 0, 0]), (2, [0, 1, 0, 1]), (4, [0, 1, 2, 3])])
def test_shards_wrap_onto_fewer_gpus(monkeypatch, count, want):
    """A deliberate difference: JAX clamps to the devices it has; the port
    wraps shard i onto cuda:(i % count), with a warning."""
    warnings = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(mesh_mod.log, "warning", lambda msg, *a: warnings.append(msg % a))
    got = search_devices(4, "cuda")
    assert got == [torch.device("cuda", i) for i in want]
    assert bool(warnings) == (count < 4)
    assert encode_devices(4, "cuda") == got
    assert search_devices(0, "cuda") == [torch.device("cuda", i) for i in range(count)]


# ------------------------------------------------------- flat index vs JAX


def _flat_pair(n, dtype, backend="xla", cap=1024):
    jdt, tdt = DTYPES[dtype]
    jidx = JaxShardedFlat(search_mesh(n_shards=n), dim=D, capacity_per_shard=cap, dtype=jdt)
    tidx = ShardedFlatIndex(search_devices(n, "cpu"), dim=D, capacity_per_shard=cap,
                            dtype=tdt, backend=backend)
    return jidx, tidx


def _slot_ids(tidx):
    """The port's slot -> id arrays at JAX's global slots (shard x cap +
    local)."""
    return np.concatenate([s._ids for s in tidx.shards])


def _assert_same(jidx, tidx, q, k=10):
    j_ids, j_s = jidx.search(q, k)
    t_ids, t_s = tidx.search(q, k)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, atol=1e-5)
    return t_ids, t_s


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_flat_matches_jax_through_mutations(eight_devices, n, dtype):
    rng = np.random.default_rng(n)
    jidx, tidx = _flat_pair(n, dtype)
    assert tidx.backend == jidx.backend == "xla"
    q = _unit(rng, 6)
    ids = np.arange(1, 601, dtype=np.int64) * 3
    x = _unit(rng, 600)
    for idx in (jidx, tidx):
        idx.upsert(ids, x)
    _assert_same(jidx, tidx, q)
    np.testing.assert_array_equal(tidx._fill, jidx._fill)
    np.testing.assert_array_equal(_slot_ids(tidx), jidx._ids)

    over = _unit(rng, 40)          # overwrite: same slots, new rows
    for idx in (jidx, tidx):
        idx.upsert(ids[:40], over)
    t_ids, t_s = _assert_same(jidx, tidx, over[:4], k=4)
    assert (t_ids[:, 0] == ids[:4]).all() and (t_s[:, 0] > 0.95).all()

    assert jidx.delete(ids[40:140]) == tidx.delete(ids[40:140]) == 100
    t_ids, _ = _assert_same(jidx, tidx, x[40:46])
    assert not set(t_ids.ravel()) & set(ids[40:140].tolist())

    # past capacity: every shard doubles, global slots renumber (the shards are
    # filled to the brim first: growth inside one upsert is where the JAX
    # package misplaces rows, test_growth_inside_one_upsert_keeps_every_row)
    grow = 1024 * n + 300 - 600
    more_ids = np.arange(10_000, 10_000 + grow, dtype=np.int64)
    more = _unit(rng, grow)
    brim = 1024 * n - 600
    for idx in (jidx, tidx):
        idx.upsert(more_ids[:brim], more[:brim])
        assert idx.cap_per_shard == 1024
        idx.upsert(more_ids[brim:], more[brim:])
    assert tidx.cap_per_shard == jidx.cap_per_shard == 2048
    assert tidx.count() == jidx.count() == 500 + grow
    np.testing.assert_array_equal(_slot_ids(tidx), jidx._ids)
    _assert_same(jidx, tidx, q)
    stored = np.concatenate([s._vectors.float().numpy() for s in tidx.shards])
    np.testing.assert_array_equal(stored, np.asarray(jidx._vectors, np.float32))


def test_growth_inside_one_upsert_keeps_every_row(eight_devices):
    """A fault of the reference: when the shards fill up inside one upsert,
    JAX's ShardedFlatIndex writes the rows it placed before the doubling at
    their old slot numbers, so they land in another shard's rows and cannot
    be found. The port's shards keep their local slots across the doubling."""
    rng = np.random.default_rng(9)
    x = _unit(rng, 3000)
    ids = np.arange(1, 3001, dtype=np.int64)
    jidx, tidx = _flat_pair(2, "float32")
    for idx in (jidx, tidx):
        idx.upsert(ids[:2000], x[:2000])
        idx.upsert(ids[2000:], x[2000:])     # 48 rows fit, then every shard doubles
        assert idx.cap_per_shard == 2048
    # the 24 rows shard 1 took before the doubling (ids 2002, 2004, ..., 2048)
    before = ids[2001:2048:2]
    t_ids, t_s = tidx.search(x[before - 1], 1)
    assert (t_ids[:, 0] == before).all() and (t_s[:, 0] > 0.999).all()
    j_ids, _ = jidx.search(x[before - 1], 1)
    assert not (j_ids[:, 0] == before).any()
    np.testing.assert_array_equal(_slot_ids(tidx), jidx._ids)     # the id maps agree


def test_sharded_flat_is_shard_count_invariant():
    rng = np.random.default_rng(7)
    n_rows, k = 4096, 10
    x = _unit(rng, n_rows, 128)
    ids = np.arange(100, 100 + n_rows, dtype=np.int64)
    q = _unit(rng, 6, 128)
    idx8 = ShardedFlatIndex(search_devices(8, "cpu"), dim=128, capacity_per_shard=1024,
                            dtype=torch.float32)
    idx8.upsert(ids, x)
    ids8, s8 = idx8.search(q, k)
    s = q @ x.T
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids8, ids[order])
    np.testing.assert_allclose(s8, np.take_along_axis(s, order, axis=1), atol=1e-5)
    idx1 = ShardedFlatIndex(search_devices(1, "cpu"), dim=128, capacity_per_shard=8192,
                            dtype=torch.float32)
    idx1.upsert(ids, x)
    ids1, s1 = idx1.search(q, k)
    np.testing.assert_array_equal(ids8, ids1)
    np.testing.assert_allclose(s8, s1, atol=1e-6)


def test_sharded_flat_breaks_ties_to_the_lower_shard():
    """Duplicate rows score alike: the merge keeps the shard-major order."""
    rng = np.random.default_rng(2)
    row = _unit(rng, 1)
    idx = ShardedFlatIndex(search_devices(4, "cpu"), dim=D, capacity_per_shard=1024,
                           dtype=torch.float32)
    idx.upsert(np.arange(1, 9, dtype=np.int64), np.repeat(row, 8, axis=0))
    got, s = idx.search(row, 8)
    # round robin: ids 1-4 take local slot 0 of shards 0-3, ids 5-8 slot 1
    assert got[0].tolist() == [1, 5, 2, 6, 3, 7, 4, 8]
    assert np.all(s[0] == s[0, 0])


def test_sharded_flat_empty_and_tiny():
    idx = ShardedFlatIndex(search_devices(4, "cpu"), dim=D, capacity_per_shard=1024)
    ids, s = idx.search(np.ones(D, np.float32), 5)
    assert ids.shape == (1, 5) and (ids == 0).all() and np.isneginf(s).all()
    rng = np.random.default_rng(3)
    x = _unit(rng, 3)
    idx.upsert([7, 8, 9], x)
    ids, s = idx.search(x[1], 5)
    assert ids[0, 0] == 8 and sorted(ids[0, :3].tolist()) == [7, 8, 9]
    assert (ids[0, 3:] == 0).all() and np.isneginf(s[0, 3:]).all()


def test_sharded_flat_backends_and_refusals(monkeypatch):
    idx = ShardedFlatIndex(search_devices(2, "cpu"), dim=D)
    assert idx.backend == "xla" and idx.n_shards == 2 and idx.cap_per_shard == 8192
    with pytest.raises(ValueError, match="unknown backend"):
        ShardedFlatIndex(search_devices(2, "cpu"), dim=D, backend="pallas_fused")
    # K6 stays narrow on CUDA: each shard's FlatIndex refuses before it
    # makes a tensor, so a machine without a card reaches the refusal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="K6"):
        ShardedFlatIndex([torch.device("cuda", 0)], dim=768, backend="pallas_exact")


# ------------------------------------------------------ K7 per shard vs JAX


def _jax_composition(tidx, q, k, nbuckets):
    """JAX's bucketed_topk (interpret mode) on each of the port's shards,
    then the sharded index's merge as JAX writes it: offsets, shard-major
    concatenation, lax.top_k, the slot -> id map and the -100 filter."""
    s_all, i_all = [], []
    for shard, part in enumerate(tidx.shards):
        corpus = part._vectors
        jc = jnp.asarray(corpus.numpy() if corpus.dtype != torch.bfloat16
                         else corpus.float().numpy(), DTYPES[_name(corpus.dtype)][0])
        s, i = jax_bucketed_topk(jnp.asarray(q), jc, jnp.asarray(part._valid.numpy()), k,
                                 nbuckets=nbuckets, interpret=True)
        s_all.append(s)
        i_all.append(jnp.where(i >= 0, i + shard * tidx.cap_per_shard, -1))
    top_s, pos = jax.lax.top_k(jnp.concatenate(s_all, axis=1), k)
    gi = np.asarray(jnp.take_along_axis(jnp.concatenate(i_all, axis=1), pos, axis=1))
    s = np.array(top_s)
    ids = np.where(gi >= 0, _slot_ids(tidx)[np.maximum(gi, 0)], 0)
    bad = s < -100.0
    ids[bad] = 0
    s[bad] = -np.inf
    return ids, s


def _name(dtype):
    return {v[1]: k for k, v in DTYPES.items()}[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k7_per_shard_matches_jax_bucketed_topk(dtype):
    """cap_per_shard (4,096) is 4x nbuckets (1,024): rows of one shard
    collide in every bucket, so the result is K7's near-exact one."""
    rng = np.random.default_rng(11)
    nbuckets, k = 1024, 24
    tidx = ShardedFlatIndex(search_devices(4, "cpu"), dim=D, capacity_per_shard=4096,
                            dtype=DTYPES[dtype][1], backend="pallas_bucketed",
                            nbuckets=nbuckets)
    n_rows = 4 * 3500
    ids = np.arange(1, n_rows + 1, dtype=np.int64) * 5
    x = _unit(rng, n_rows)
    tidx.upsert(ids, x)
    tidx.delete(ids[:199])
    q = _unit(rng, 8)
    t_ids, t_s = tidx.search(q, k)
    j_ids, j_s = _jax_composition(tidx, q, k, nbuckets)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, atol=1e-5)
    # near-exact: the bucket collisions lose some of the exact top k
    s = q @ x[199:].T
    exact = ids[199:][np.argsort(-s, axis=1, kind="stable")[:, :k]]
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(t_ids, exact)])
    assert 0.5 < recall < 1.0, recall


# ---------------------------------------------------------- persistence


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_from,n_to", [(2, 4), (4, 1)])
def test_sharded_flat_checkpoints_cross_packages(eight_devices, tmp_path, dtype, n_from, n_to):
    rng = np.random.default_rng(5)
    jdt, tdt = DTYPES[dtype]
    x = _unit(rng, 700)
    ids = np.arange(1, 701, dtype=np.int64)
    q = _unit(rng, 5)
    port = ShardedFlatIndex(search_devices(n_from, "cpu"), dim=D, capacity_per_shard=1024,
                            dtype=tdt, name="c")
    jidx = JaxShardedFlat(search_mesh(n_shards=n_from), dim=D, capacity_per_shard=1024,
                          dtype=jdt, name="c")
    for idx in (port, jidx):
        idx.upsert(ids, x)
        idx.delete(ids[:50])
    want_ids, want_s = port.search(q, 10)
    port.save(tmp_path / "port")
    jidx.save(tmp_path / "jax")
    for src in ("port", "jax"):
        # each package loads either checkpoint onto n_to shards; both give
        # the same answer (an int8 load re-quantizes the decoded rows in
        # either package, so only f32 keeps the saved index's own answer)
        j2 = JaxShardedFlat.load(tmp_path / src, search_mesh(n_shards=n_to), name="c")
        t2 = ShardedFlatIndex.load(tmp_path / src, search_devices(n_to, "cpu"), name="c")
        assert j2.count() == t2.count() == 650 and t2.n_shards == n_to
        assert t2.dtype == tdt and t2.cap_per_shard == 1024
        got_ids, got_s = _assert_same(j2, t2, q)
        if dtype == "float32":
            np.testing.assert_array_equal(got_ids, want_ids)
            np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    m = json.loads((tmp_path / "port" / "c.manifest.json").read_text())
    assert m == json.loads((tmp_path / "jax" / "c.manifest.json").read_text())


def test_flat_checkpoints_load_into_sharded_mode(tmp_path):
    rng = np.random.default_rng(6)
    x = _unit(rng, 500)
    ids = np.arange(1, 501, dtype=np.int64)
    q = _unit(rng, 4)
    port_flat = FlatIndex(dim=D, capacity=1024, dtype=torch.float32, name="f", device="cpu")
    jax_flat = JaxFlatIndex(dim=D, capacity=1024, dtype=jnp.float32, name="f", backend="xla")
    for idx in (port_flat, jax_flat):
        idx.upsert(ids, x)
        idx.delete(ids[:20])
    want_ids, want_s = port_flat.search(q, 8)
    port_flat.save(tmp_path / "port")
    jax_flat.save(tmp_path / "jax")
    for where in ("port", "jax"):
        sh = ShardedFlatIndex.load(tmp_path / where, search_devices(4, "cpu"), name="f")
        assert sh.count() == 480 and sh.cap_per_shard == 1024
        got_ids, got_s = sh.search(q, 8)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_s, want_s, atol=1e-5)


# ------------------------------------------------------------ sharded IVF


def _ivf_pair(n, dtype="float32", nlist=4, nprobe=4):
    jdt, tdt = DTYPES[dtype]
    j = JaxShardedIVF(dim=D, n_shards=n, nlist=nlist, list_size=128, nprobe=nprobe,
                      dtype=jdt, name="sivf")
    t = ShardedIVFIndex(search_devices(n, "cpu"), dim=D, nlist=nlist, list_size=128,
                        nprobe=nprobe, dtype=tdt, name="sivf")
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_ivf_matches_jax(eight_devices, dtype):
    rng = np.random.default_rng(3)
    x = _unit(rng, 300)
    ids = np.arange(1, 301, dtype=np.int64)
    jidx, tidx = _ivf_pair(3, dtype)
    for idx in (jidx, tidx):
        idx.train(x, iters=4)
        idx.upsert(ids[:200], x[:200])
        idx.upsert(ids[100:], x[100:])            # overwrites keep their shard
    assert tidx._owner == jidx._owner and tidx._rr == jidx._rr == 300
    assert [s.count() for s in tidx.shards] == [s.count() for s in jidx.shards] == [100] * 3
    assert all(s.device == torch.device("cpu") for s in tidx.shards)
    q = _unit(rng, 6)
    # the full probe is exact whatever the centroids
    t_ids, t_s = tidx.search(q, 8, nprobe=4)
    j_ids, j_s = jidx.search(q, 8, nprobe=4)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, atol=1e-5)
    if dtype == "float32":
        s = q @ x.T
        order = np.argsort(-s, axis=1, kind="stable")[:, :8]
        np.testing.assert_array_equal(t_ids, ids[order])
    assert jidx.delete(ids[:30]) == tidx.delete(ids[:30]) == 30
    t_ids, _ = tidx.search(x[:30], 8, nprobe=4)
    assert not set(t_ids.ravel()) & set(ids[:30].tolist())
    tidx.nprobe = 99
    assert all(s.nprobe == 4 for s in tidx.shards)


def test_sharded_ivf_int8_recall_and_save_load(tmp_path):
    rng = np.random.default_rng(13)
    d, n = 64, 2000
    centers = _unit(rng, 16, d)
    x = centers[rng.integers(0, 16, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = np.arange(1, n + 1, dtype=np.int64)
    idx = ShardedIVFIndex(search_devices(4, "cpu"), dim=d, nlist=8, list_size=256, nprobe=8,
                          dtype=torch.int8, name="sivf_i8")
    idx.train(x[:1000], iters=6)
    idx.upsert(ids, x)
    q = x[:20] + 0.05 * rng.standard_normal((20, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got_ids, got_s = idx.search(q, 5)
    s_ref = q @ x.T
    order = np.argsort(-s_ref, axis=1, kind="stable")[:, :5]
    recall = np.mean([len(set(a.tolist()) & set(ids[o].tolist())) / 5
                      for a, o in zip(got_ids, order)])
    assert recall >= 0.9, recall
    assert np.all(got_s <= 1.05)
    idx.save(tmp_path)
    idx2 = ShardedIVFIndex.load(tmp_path, search_devices(4, "cpu"), name="sivf_i8")
    assert all(s.dtype == torch.int8 for s in idx2.shards)
    b_ids, b_s = idx2.search(q, 5)
    np.testing.assert_array_equal(got_ids, b_ids)
    np.testing.assert_allclose(got_s, b_s, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_ivf_checkpoints_cross_packages(eight_devices, tmp_path, dtype):
    rng = np.random.default_rng(4)
    x = _unit(rng, 200)
    ids = np.arange(1, 201, dtype=np.int64)
    jidx, tidx = _ivf_pair(2, dtype)
    for idx in (jidx, tidx):
        idx.train(x, iters=4)
        idx.upsert(ids, x)
        assert idx.delete([1, 2, 3]) == 3
    jidx.save(tmp_path / "jax")
    tidx.save(tmp_path / "port")
    q = x[10:14]
    for src, want in (("jax", jidx), ("port", tidx)):
        t2 = ShardedIVFIndex.load(tmp_path / src, search_devices(2, "cpu"), name="sivf")
        j2 = JaxShardedIVF.load(tmp_path / src, n_shards=2, name="sivf")
        assert t2.count() == j2.count() == 197 and t2._owner == want._owner
        assert t2.shards[0].dtype == DTYPES[dtype][1]
        w_ids, w_s = want.search(q, 5)
        for idx in (t2, j2):
            got_ids, got_s = idx.search(q, 5)
            np.testing.assert_array_equal(got_ids, w_ids)
            np.testing.assert_allclose(got_s, w_s, atol=1e-5)


def _clustered(rng, n, d, k=24, spread=0.25):
    centers = _unit(rng, k, d)
    x = centers[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d)) / np.sqrt(d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_sharded_ivf_tuning_applies_to_all_shards(tmp_path):
    rng = np.random.default_rng(123)
    d, n = 64, 3000
    x = _clustered(rng, n, d)
    idx = ShardedIVFIndex(search_devices(2, "cpu"), dim=d, nlist=16, list_size=256,
                          nprobe=16, name="tuned")
    idx.train(x[:1500], iters=8)
    idx.upsert(np.arange(1, 1 + n, dtype=np.int64), x)
    report = idx.tune_nprobe(k=10, target_recall=0.9, sample=64)
    assert report["nprobe"] < idx.nlist
    assert all(s.nprobe == report["nprobe"] for s in idx.shards)
    assert idx.nprobe == report["nprobe"]
    idx.save(tmp_path)
    assert ShardedIVFIndex.load(tmp_path, search_devices(2, "cpu"),
                                name="tuned").nprobe == report["nprobe"]
    sample = idx.sample_vectors(100, seed=1)
    assert sample.shape == (100, d)


def test_sharded_ivf_retrain_keeps_every_id():
    rng = np.random.default_rng(8)
    x = _unit(rng, 240)
    idx = ShardedIVFIndex(search_devices(3, "cpu"), dim=D, nlist=4, list_size=128, nprobe=4,
                          dtype=torch.float32)
    idx.upsert(np.arange(1, 241, dtype=np.int64), x)
    before, _ = idx.search(x[:5], 5)
    idx.retrain(iters=4)
    assert idx.count() == 240 and idx.is_trained
    after, _ = idx.search(x[:5], 5)
    np.testing.assert_array_equal(after, before)


# ----------------------------------------------------- data-parallel encode


TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            vocab_size=30522, max_position=512)
TEXTS = [f"invoice amount {i} rupees gst lease rent" for i in range(13)]


@pytest.fixture(scope="module")
def tiny_params():
    from financial_rag_tpu.config import ModelConfig as JaxModelConfig
    from financial_rag_tpu.models import checkpoint as jckpt
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models import checkpoint

    jcfg, tcfg = JaxModelConfig(name="tiny", **TINY), ModelConfig(name="tiny", **TINY)
    jp = jckpt.random_params(jcfg, seed=0)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jcfg, tcfg, jp, checkpoint.params_from_numpy(tree)


@pytest.mark.parametrize("dp", [2, 4])
def test_data_parallel_encode_matches_single_device_and_jax(eight_devices, tiny_params, dp):
    from jax.sharding import Mesh

    from financial_rag_tpu.models.encoder import Encoder as JaxEncoder
    from financial_rag_tpu_torch.models.encoder import Encoder

    jcfg, tcfg, jp, tp = tiny_params
    single = Encoder(tcfg, tp, pooling="mean", batch_size=8, max_seq_len=128, device="cpu")
    port_dp = Encoder(tcfg, tp, pooling="mean", batch_size=8, max_seq_len=128, device="cpu",
                      replicas=encode_devices(dp, "cpu"))
    jax_dp = JaxEncoder(jcfg, jp, pooling="mean", batch_size=8, max_seq_len=128,
                        mesh=Mesh(np.array(eight_devices[:dp]), ("data",)))
    assert port_dp.n_replicas == dp and port_dp.batch_size == jax_dp.batch_size == 8
    # replicas on one device share one copy of the weights
    assert len(port_dp._params_on) == 1
    got = port_dp.encode(TEXTS)
    np.testing.assert_allclose(got, single.encode(TEXTS), atol=2e-5)
    np.testing.assert_allclose(got, jax_dp.encode(TEXTS), atol=2e-5)
    dev = port_dp.encode_begin_device(TEXTS)()
    assert dev.device == torch.device("cpu") and dev.shape == (13, 64)
    np.testing.assert_allclose(dev.numpy(), got, atol=1e-6)
    pinned = port_dp.encode_begin_device(TEXTS[:3], seq_bucket=64, rows_bucket=8)()
    np.testing.assert_allclose(pinned.numpy(), got[:3], atol=2e-5)


def test_batch_bucket_floors_at_the_replica_count(tiny_params):
    from types import SimpleNamespace

    from financial_rag_tpu.models.encoder import Encoder as JaxEncoder
    from financial_rag_tpu_torch.models.encoder import Encoder

    jcfg, tcfg, jp, tp = tiny_params
    enc = Encoder(tcfg, tp, batch_size=100, device="cpu", replicas=["cpu"] * 16)
    jenc = JaxEncoder(jcfg, jp, batch_size=100, mesh=SimpleNamespace(size=16))
    assert enc.batch_size == jenc.batch_size == 112
    for n in (1, 3, 9, 20, 33, 100):
        assert enc._batch_bucket(n) == jenc._batch_bucket(n)
        assert enc._batch_bucket(n) % 16 == 0
    enc8 = Encoder(tcfg, tp, batch_size=128, device="cpu", replicas=["cpu"] * 8)
    jenc8 = JaxEncoder(jcfg, jp, batch_size=128, mesh=SimpleNamespace(size=8))
    assert enc8._batch_bucket(3) == jenc8._batch_bucket(3) == 8
    assert enc8._batch_bucket(20) == jenc8._batch_bucket(20) == 32


# ----------------------------------------------------------------- runtime


FACTS = [
    "TAX INVOICE / CREDIT NOTE No. CN/24 dated 30-Jul-22 issued by Bhartiya Enterprises.",
    "Taxable value Rs 2,15,625 and CGST at 9 percent Rs 19,406.25 on the credit note.",
    "Total credit note amount Rs 2,54,434 rounded, GSTIN 20AAIPL4886F1ZQ.",
    "The monthly rent for the second year shall be Rs 42,800 under the lease deed.",
    "The lock-in period is 36 months from the commencement date of 1 April 2022.",
    "A security deposit of Rs 2,40,000 is payable on signing the lease.",
    "The fire insurance policy FI-9981 has a sum insured of Rs 75,00,000.",
    "The travel reimbursement cap is Rs 3,500 per trip for domestic travel.",
]
# one page per fact, each long enough for several children
DOC = {"blocks": [{"content": (fact + " ") * 12, "page": i} for i, fact in enumerate(FACTS)]}


def _fallback_config(**mesh):
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = cfg.encoders.gte_path = cfg.rerank.model_path = None
    cfg.index.capacity = 4096
    cfg.llm.gemini_api_key = None
    for k, v in mesh.items():
        setattr(cfg.mesh, k, v)
    return cfg


def _ingest_doc(rt, tmp_path, name="cn", doc=DOC):
    src = tmp_path / f"{name}.json"
    src.write_text(json.dumps(doc))
    out = rt.pipeline.ingest_extracted_json(src, name)
    assert "error" not in out and out["children"] > 0


def test_runtime_builds_sharded_flat_and_reloads(tmp_path):
    rt = Runtime.build(_fallback_config(index_shards=4), data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, ShardedFlatIndex) and i.n_shards == 4 and i.cap_per_shard == 1024
               for i in rt.indexes.values())
    _ingest_doc(rt, tmp_path)
    out = rt.engine.query("credit note number")
    assert out["success"] and out["top_children_chunks"]
    counts = {n: i.count() for n, i in rt.indexes.items()}
    assert all(c > 0 for c in counts.values())
    # the batcher's warmup takes the sharded index's search (no search_begin)
    assert not hasattr(type(rt.indexes["baai"]), "supports_search_begin")
    rt.warm_sweeps()
    rt.save_indexes(tmp_path)
    rt2 = Runtime.build(_fallback_config(index_shards=4), data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, ShardedFlatIndex) for i in rt2.indexes.values())
    assert {n: i.count() for n, i in rt2.indexes.items()} == counts
    out2 = rt2.engine.query("credit note number")
    assert out2["success"] and out2["top_children_chunks"]


def test_runtime_loads_a_flat_checkpoint_into_sharded_mode(tmp_path):
    rt = Runtime.build(_fallback_config(), data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, FlatIndex) for i in rt.indexes.values())
    _ingest_doc(rt, tmp_path)
    counts = {n: i.count() for n, i in rt.indexes.items()}
    want = rt.dense_retriever.query("tax invoice credit note", top_k=3)
    rt.save_indexes(tmp_path)
    rt2 = Runtime.build(_fallback_config(index_shards=4), data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, ShardedFlatIndex) for i in rt2.indexes.values())
    assert {n: i.count() for n, i in rt2.indexes.items()} == counts
    got = rt2.dense_retriever.query("tax invoice credit note", top_k=3)
    assert [h["child_id"] for h in got["child_hits"]] == \
        [h["child_id"] for h in want["child_hits"]]


def test_runtime_builds_sharded_ivf_streams_and_reloads(tmp_path):
    cfg = _fallback_config(index_shards=4)
    cfg.index.kind = "ivf"
    cfg.index.ivf_nlist = cfg.index.ivf_nprobe = 4
    rt = Runtime.build(cfg, data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, ShardedIVFIndex) and i.n_shards == 4 for i in rt.indexes.values())
    assert all(i.name.endswith("_ivf_sharded") for i in rt.indexes.values())
    _ingest_doc(rt, tmp_path)
    assert rt.engine.query("credit note number")["success"]
    # streaming: ingest after a search is searchable
    _ingest_doc(rt, tmp_path, "extra", {"blocks": [
        {"content": "The warehouse lease deposit equals 7,77,777 rupees. " * 12, "page": 0}]})
    out = rt.engine.query("warehouse lease deposit")
    assert out["success"]
    assert any("7,77,777" in c["text"] for c in out["top_children_chunks"])
    counts = {n: i.count() for n, i in rt.indexes.items()}
    rt.save_indexes(tmp_path)
    rt2 = Runtime.build(cfg, data_dir=tmp_path, device="cpu")
    assert all(isinstance(i, ShardedIVFIndex) for i in rt2.indexes.values())
    assert {n: i.count() for n, i in rt2.indexes.items()} == counts


def test_runtime_sizes_sharded_ivf_as_jax_does(tmp_path):
    cfg = _fallback_config(index_shards=4)
    cfg.index.kind = "ivf"
    cfg.index.capacity = 0            # the 131,072 planning default
    rt = Runtime.build(cfg, data_dir=tmp_path, device="cpu")
    idx = rt.indexes["baai"]
    # planned_capacity // shards = 32,768 -> nlist 1,024 (recommended_nlist), lists of 128
    assert (idx.nlist, idx.shards[0].list_size, idx.nprobe) == (1024, 128, 64)


def test_admin_compact_and_save_reach_sharded_indexes(tmp_path):
    """As in the JAX app: a sharded IVF retrains (it has no compact), a
    sharded flat index is skipped, and /admin/save writes every shard."""
    from werkzeug.test import Client

    flat = Runtime.build(_fallback_config(index_shards=2), data_dir=tmp_path / "flat",
                         device="cpu")
    _ingest_doc(flat, tmp_path)
    out = Client(flat.make_app(data_dir=tmp_path / "flat")).post("/admin/compact").get_json()
    assert out["collections"] == {n: {"skipped": True} for n in flat.indexes}

    cfg = _fallback_config(index_shards=2)
    cfg.index.kind = "ivf"
    cfg.index.ivf_nlist = cfg.index.ivf_nprobe = 4
    rt = Runtime.build(cfg, data_dir=tmp_path, device="cpu")
    _ingest_doc(rt, tmp_path)
    counts = {n: i.count() for n, i in rt.indexes.items()}
    client = Client(rt.make_app(data_dir=tmp_path))
    out = client.post("/admin/compact").get_json()["collections"]
    assert out == {n: {"retrained": True, "count": c} for n, c in counts.items()}
    assert client.post("/admin/save").status_code == 200
    saved = tmp_path / cfg.index.persist_dir
    assert all((saved / f"{i.name}_1.manifest.json").exists() for i in rt.indexes.values())


# ----------------------------------------------------- mutation and races


def _sharded(kind):
    if kind == "sharded_flat":
        return ShardedFlatIndex(search_devices(4, "cpu"), dim=D, capacity_per_shard=1024,
                                dtype=torch.float32)
    return ShardedIVFIndex(search_devices(4, "cpu"), dim=D, nlist=8, list_size=128,
                           nprobe=8, dtype=torch.float32)


KINDS = ["sharded_flat", "sharded_ivf"]


@pytest.mark.parametrize("kind", KINDS)
def test_upsert_after_search_is_visible(kind):
    rng = np.random.default_rng(0)
    idx = _sharded(kind)
    idx.upsert(np.arange(1, 65, dtype=np.int64), _unit(rng, 64))
    idx.search(_unit(rng, 2), 4)
    probe = _unit(rng, 1)
    idx.upsert([999], probe)
    ids, scores = idx.search(probe, 4)
    assert ids[0, 0] == 999 and scores[0, 0] == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_delete_after_search_is_invisible(kind):
    rng = np.random.default_rng(1)
    idx = _sharded(kind)
    base = _unit(rng, 64)
    ids_in = np.arange(1, 65, dtype=np.int64)
    idx.upsert(ids_in, base)
    assert idx.search(base[6:7], 4)[0][0, 0] == 7
    idx.delete([7])
    ids, scores = idx.search(base[6:7], 8)
    assert 7 not in ids[0].tolist()
    live = set(ids_in.tolist()) - {7}
    for cid, s in zip(ids[0].tolist(), scores[0].tolist()):
        assert (cid in live) or (cid == 0 and s == -np.inf), (cid, s)


@pytest.mark.parametrize("kind", KINDS)
def test_overwrite_after_search_updates_scores(kind):
    rng = np.random.default_rng(2)
    idx = _sharded(kind)
    idx.upsert(np.arange(1, 65, dtype=np.int64), _unit(rng, 64))
    idx.search(_unit(rng, 1), 4)
    new_vec = _unit(rng, 1)
    idx.upsert([5], new_vec)
    ids, scores = idx.search(new_vec, 4)
    assert ids[0, 0] == 5 and scores[0, 0] == pytest.approx(1.0, abs=1e-3)


def test_grow_replaces_the_id_map_and_tensors():
    """One new row past a full index doubles every shard at once, into new
    tensors and new slot -> id arrays; local slots keep their numbers, the
    global (saved) slots move."""
    rng = np.random.default_rng(3)
    sh = ShardedFlatIndex(search_devices(2, "cpu"), dim=D, capacity_per_shard=1024,
                          dtype=torch.float32)
    n = sh.cap_per_shard * sh.n_shards
    sh.upsert(np.arange(1, n + 1, dtype=np.int64), _unit(rng, n))
    ids0 = [s._ids for s in sh.shards]
    vec0 = [s._vectors for s in sh.shards]
    g0 = _slot_ids(sh)
    sh.upsert([n + 5], _unit(rng, 1))
    assert sh.cap_per_shard == 2048 and [s.capacity for s in sh.shards] == [2048, 2048]
    assert all(s._ids is not i and s._vectors is not v
               for s, i, v in zip(sh.shards, ids0, vec0))
    assert ids0[1][0] == sh.shards[1]._ids[0] == 2      # shard 1's first row
    assert g0[1024] == 2 and _slot_ids(sh)[2048] == 2   # its global slot, renumbered


@pytest.mark.parametrize("kind", KINDS)
def test_concurrent_writers_and_readers(kind):
    """Writers and readers racing: no exception, the final count exact, a
    fresh upsert searchable at once."""
    rng = np.random.default_rng(4)
    idx = _sharded(kind)
    idx.upsert(np.arange(1, 33, dtype=np.int64), _unit(rng, 32))
    errors = []
    vecs = _unit(rng, 3 * 5 * 4 + 10 * 2 * 3)

    def writer(w):
        try:
            for i in range(5):
                lo = w * 20 + i * 4
                idx.upsert(np.arange(lo, lo + 4, dtype=np.int64) + 100, vecs[lo:lo + 4])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader(r):
        try:
            for i in range(10):
                idx.search(vecs[60 + r * 20 + 2 * i: 62 + r * 20 + 2 * i], 5)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
    threads += [threading.Thread(target=reader, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 32 + 3 * 5 * 4
    probe = _unit(rng, 1)
    idx.upsert([99999], probe)
    assert idx.search(probe, 1)[0][0, 0] == 99999


def test_search_and_save_never_mix_epochs_across_growth(tmp_path):
    """Row c always holds table[c]: a search for table[c] of an id already
    in must find c itself, and every saved (id, row) pair must match the
    table, while writers upsert through two doublings of every shard."""
    rng = np.random.default_rng(5)
    table = _unit(rng, 6001)
    idx = ShardedFlatIndex(search_devices(2, "cpu"), dim=D, capacity_per_shard=1024,
                           dtype=torch.float32, name="race")
    idx.upsert(np.arange(1, 401), table[1:401])
    inserted = list(range(1, 401))
    errors, lock = [], threading.Lock()

    def writer():
        try:
            for lo in range(401, 6001, 100):
                ids = np.arange(lo, lo + 100)
                idx.upsert(ids, table[ids])
                with lock:
                    inserted.extend(ids.tolist())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(40):
                with lock:
                    c = inserted[int(r.integers(0, len(inserted)))]
                got, s = idx.search(table[c], 1)
                if got[0, 0] != c or s[0, 0] < 0.999:
                    errors.append(f"search for {c} gave {got[0, 0]} at {s[0, 0]}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def saver():
        try:
            for i in range(3):
                idx.save(tmp_path / f"s{i}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=saver)]
    threads += [threading.Thread(target=reader, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    assert idx.count() == 6000 and idx.cap_per_shard == 4096
    for i in range(3):
        data = np.load(tmp_path / f"s{i}" / "race.npz")
        live = data["valid"] > 0
        saved_ids = data["ids"][live]
        assert len(saved_ids) >= 400
        np.testing.assert_allclose(data["vectors"][live], table[saved_ids], atol=1e-6)


# ------------------------------------------------------------- full engine


@pytest.fixture(scope="module")
def engines(tmp_path_factory, eight_devices):
    """The dryrun's section 6 (the port's sharded + data-parallel runtime
    against its single-device one, a stream joining the continuous decode),
    then the JAX package's sharded runtime on the same checkpoints."""
    from financial_rag_tpu.runtime import Runtime as JaxRuntime
    from financial_rag_tpu_torch.scripts import dryrun_multichip as dry

    base = tmp_path_factory.mktemp("engine")
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(base / "jax_cache"))
    try:
        report = dry.full_engine(4, torch.device("cpu"), base)
        cfg = dry.engine_config(JaxFrameworkConfig(), base / "ckpt", 4, 4)
        jrt = JaxRuntime.build(cfg, data_dir=base / "jax")
        jrt.pipeline.ingest_extracted_json(base / "lease.json", "lease-jax")
        assert all(isinstance(i, JaxShardedFlat) for i in jrt.indexes.values())
        want = dry.engine_answers(jrt)
        inner = getattr(jrt.engine.llm, "inner", None)
        if getattr(inner, "_engine", None) is not None:
            inner._engine.close()
        jrt.feedback_db.flush_writes()
    finally:
        mp.undo()
    return report, want


def test_sharded_engine_answers_as_the_single_device_one(engines):
    report, _ = engines
    assert report["questions"] == 3 and report["joins"] >= 1
    assert all(texts and answer for texts, answer in report["answers"])
    # random weights, but the answers depend on the question
    assert len({answer for _, answer in report["answers"]}) == 3


@pytest.mark.parametrize("q", range(3))
def test_sharded_engine_answers_as_the_jax_sharded_engine(engines, q):
    report, want = engines
    texts, answer = report["answers"][q]
    assert texts == want[q][0]
    assert answer == want[q][1]
