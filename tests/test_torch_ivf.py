"""The port's IVF index, nprobe tuning and IVF runtime against the JAX
package's.

``jax.random`` and ``torch.Generator`` draw different numbers from one seed,
so where results are compared the centroids are carried across (set from
numpy, or loaded from an index the other package saved); the port's own
k-means is held to the JAX package's quality test. The mutation cases of
tests/test_index_mutation.py and the tuning cases of tests/test_tuning.py
run here on the port.
"""

import json
import logging
import shutil
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from financial_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex
from financial_rag_tpu.index.ivf import recommended_nlist as jax_recommended_nlist
from financial_rag_tpu.runtime import _ivf_list_size as jax_ivf_list_size
from financial_rag_tpu_torch.index import IVFIndex, kmeans, recommended_nlist
from financial_rag_tpu_torch.index import tuning as tuning_mod
from financial_rag_tpu_torch.ops import ivf_probe
from financial_rag_tpu_torch.runtime import _ivf_list_size

torch.set_num_threads(2)

D = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_centers=16, spread=0.15):
    centers = _unit(rng, n_centers, d)
    x = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _make(dtype=torch.float32, nlist=8, name="children_ivf"):
    return IVFIndex(dim=D, nlist=nlist, list_size=128, nprobe=nlist, dtype=dtype, name=name,
                    device="cpu")


# ------------------------------------------------------------- k-means


def test_kmeans_clusters_separate_data():
    rng = np.random.default_rng(123)
    centers = _unit(rng, 4)
    pts = np.concatenate([c + 0.05 * rng.standard_normal((50, D)).astype(np.float32)
                          for c in centers])
    cents = kmeans(pts, 4, iters=10, seed=0, device="cpu")
    assert cents.shape == (4, D)
    np.testing.assert_allclose(np.linalg.norm(cents, axis=1), 1.0, atol=1e-5)
    assert (centers @ cents.T).max(axis=1).min() > 0.95


def test_kmeans_with_fewer_points_than_clusters_takes_the_jax_init():
    """k > n: both packages draw the initial centroids with numpy from the
    seed, and the empty-cluster rule cycles the points."""
    x = _unit(np.random.default_rng(3), 5)
    cents = kmeans(x, 8, iters=4, seed=0, device="cpu")
    assert cents.shape == (8, D)
    assert np.abs(cents @ x.T).max(axis=1).min() > 0.999   # every centroid is a point


@pytest.mark.parametrize("capacity", [1, 4096, 131072, 262144, 10_000_000, 1 << 40])
def test_recommended_nlist_and_list_size_match_jax(capacity):
    nlist = recommended_nlist(capacity)
    assert nlist == jax_recommended_nlist(capacity)
    assert _ivf_list_size(capacity, nlist) == jax_ivf_list_size(capacity, nlist)


# ------------------------------------------------------ parity with JAX


def _pair(dtype, nlist=8, centroids=None):
    jdt, tdt = DTYPES[dtype]
    jidx = JaxIVFIndex(dim=D, nlist=nlist, list_size=128, nprobe=3, dtype=jdt, name="c_ivf")
    tidx = IVFIndex(dim=D, nlist=nlist, list_size=128, nprobe=3, dtype=tdt, name="c_ivf",
                    device="cpu")
    jidx.centroids = jnp.asarray(centroids)
    tidx.centroids = torch.from_numpy(centroids)
    return jidx, tidx


def _assert_same(jidx, tidx, q, k=10, nprobe=None, exact_scores=False):
    j_ids, j_s = jidx.search(q, k, nprobe=nprobe)
    t_ids, t_s = tidx.search(q, k, nprobe=nprobe)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, atol=0 if exact_scores else 1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_index_matches_jax_with_the_same_centroids(dtype):
    """Same centroids, same upserts (with overflow to later candidate lists,
    overwrites, deletes and slot reuse): the same slot map and the same
    search results, at a partial and at the full probe."""
    rng = np.random.default_rng(20)
    x = _clustered(rng, 1400, D, n_centers=8)
    jidx, tidx = _pair(dtype, centroids=_unit(rng, 8))
    ids = np.arange(1, 1401, dtype=np.int64)
    for idx in (jidx, tidx):
        idx.upsert(ids[:1000], x[:1000])
        idx.delete(ids[100:300])
        idx.upsert(ids[1000:], x[1000:])          # reuses the freed slots first
        idx.upsert(ids[:50], x[1350:1400])        # overwrite in place
    np.testing.assert_array_equal(tidx._ids, jidx._ids)
    np.testing.assert_array_equal(tidx._fill, jidx._fill)
    assert tidx._loc_of == {k: (int(a), int(b)) for k, (a, b) in jidx._loc_of.items()}
    np.testing.assert_array_equal(tidx._valid.numpy(), np.asarray(jidx._valid))
    q = _clustered(rng, 12, D, n_centers=8)
    _assert_same(jidx, tidx, q)
    _assert_same(jidx, tidx, q, nprobe=8)


def test_ivf_list_growth_matches_jax():
    rng = np.random.default_rng(21)
    jidx, tidx = _pair("float32", nlist=2, centroids=_unit(rng, 2))
    x = _unit(rng, 600)
    for idx in (jidx, tidx):
        idx.upsert(np.arange(1, 601, dtype=np.int64), x)
    assert tidx.list_size == jidx.list_size == 512
    assert tuple(tidx._storage.shape) == (2, 512, D)
    np.testing.assert_array_equal(tidx._ids, jidx._ids)
    _assert_same(jidx, tidx, _unit(rng, 4), nprobe=2)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_saved_ivf_index_loads_across_packages(tmp_path, dtype):
    rng = np.random.default_rng(22)
    x = _clustered(rng, 900, D, n_centers=8)
    jidx, tidx = _pair(dtype, centroids=_unit(rng, 8))
    ids = np.arange(1, 901, dtype=np.int64)
    for idx in (jidx, tidx):
        idx.upsert(ids, x)
        idx.delete(ids[::7])
    q = _clustered(rng, 6, D, n_centers=8)
    jidx.save(tmp_path / "from_jax")
    tidx.save(tmp_path / "from_port")
    port_loaded = IVFIndex.load(tmp_path / "from_jax", name="c_ivf", device="cpu")
    jax_loaded = JaxIVFIndex.load(tmp_path / "from_port", name="c_ivf")
    assert port_loaded.dtype == DTYPES[dtype][1] and port_loaded.count() == jidx.count()
    assert sum(len(v) for v in port_loaded._free.values()) == len(ids[::7])
    _assert_same(jidx, port_loaded, q)
    _assert_same(jax_loaded, tidx, q)
    manifest = json.loads((tmp_path / "from_port" / "c_ivf.manifest.json").read_text())
    assert manifest["dtype"] == dtype and manifest["nlist"] == 8


@pytest.mark.parametrize("saved,loaded", [("bfloat16", "int8"), ("int8", "float32")])
def test_dtype_change_on_load_matches_jax(tmp_path, saved, loaded):
    """Both packages decode the saved payload by its weights and re-encode
    it for the new dtype; empty slots stay empty."""
    rng = np.random.default_rng(23)
    x = _clustered(rng, 500, D, n_centers=8)
    jidx, _ = _pair(saved, centroids=_unit(rng, 8))
    ids = np.arange(1, 501, dtype=np.int64)
    jidx.upsert(ids, x)
    jidx.delete(ids[:40])
    jidx.save(tmp_path)
    jdt, tdt = DTYPES[loaded]
    j2 = JaxIVFIndex.load(tmp_path, name="c_ivf", dtype=jdt)
    t2 = IVFIndex.load(tmp_path, name="c_ivf", dtype=tdt, device="cpu")
    assert t2.dtype == tdt and t2.count() == 460
    np.testing.assert_array_equal(t2._valid.numpy(), np.asarray(j2._valid))
    np.testing.assert_array_equal(t2._storage.float().numpy(), np.asarray(j2._storage, np.float32))
    _assert_same(j2, t2, _clustered(rng, 5, D, n_centers=8))


# --------------------------------------------- search-after-mutation cases


def test_upsert_after_search_is_visible(rng):
    idx = _make()
    idx.upsert(np.arange(1, 65, dtype=np.int64), _unit(rng, 64))
    idx.search(_unit(rng, 2), 4)
    probe = _unit(rng, 1)
    idx.upsert([999], probe)
    ids, scores = idx.search(probe, 4)
    assert ids[0, 0] == 999
    assert scores[0, 0] == pytest.approx(1.0, abs=1e-3)


def test_delete_after_search_is_invisible(rng):
    idx = _make()
    base = _unit(rng, 64)
    ids_in = np.arange(1, 65, dtype=np.int64)
    idx.upsert(ids_in, base)
    q = base[6:7]
    assert idx.search(q, 4)[0][0, 0] == 7
    idx.delete([7])
    ids, scores = idx.search(q, 8)
    assert 7 not in ids[0].tolist()
    live = set(ids_in.tolist()) - {7}
    for cid, s in zip(ids[0].tolist(), scores[0].tolist()):
        assert (cid in live) or (cid == 0 and s == -np.inf), (cid, s)


def test_overwrite_after_search_updates_scores(rng):
    idx = _make()
    idx.upsert(np.arange(1, 65, dtype=np.int64), _unit(rng, 64))
    idx.search(_unit(rng, 1), 4)
    new_vec = _unit(rng, 1)
    idx.upsert([5], new_vec)
    ids, scores = idx.search(new_vec, 4)
    assert ids[0, 0] == 5
    assert scores[0, 0] == pytest.approx(1.0, abs=1e-3)


def test_ivf_mutation_storm_matches_fresh_index(rng):
    idx = _make()
    x = _unit(rng, 256)
    ids = np.arange(1, 257, dtype=np.int64)
    idx.upsert(ids[:128], x[:128])
    idx.search(_unit(rng, 4), 8)
    idx.upsert(ids[128:192], x[128:192])
    idx.delete(ids[10:40])
    idx.search(_unit(rng, 4), 8)
    idx.upsert(ids[192:], x[192:])
    idx.delete(ids[200:210])
    live_mask = np.ones(256, bool)
    live_mask[10:40] = False
    live_mask[200:210] = False
    q = _unit(rng, 8)
    got_ids, _ = idx.search(q, 8, nprobe=8)
    fresh = _make()
    fresh.centroids = idx.centroids
    fresh.upsert(ids[live_mask], x[live_mask])
    ref_ids, _ = fresh.search(q, 8, nprobe=8)
    for a, b in zip(got_ids, ref_ids):
        assert set(a.tolist()) == set(b.tolist())


def test_ivf_delete_heavy_churn_bounds_occupancy(rng):
    idx = _make()
    x = _unit(rng, 2048)
    idx.upsert(np.arange(1, 129, dtype=np.int64), x[:128])
    next_id, live = 129, set(range(1, 129))
    start_list_size = idx.list_size
    for round_i in range(15):
        victims = sorted(live)[:64]
        idx.delete(victims)
        live -= set(victims)
        fresh = np.arange(next_id, next_id + 64, dtype=np.int64)
        idx.upsert(fresh, x[(128 + round_i * 64):(128 + (round_i + 1) * 64)])
        live |= set(fresh.tolist())
        next_id += 64
        idx.search(_unit(rng, 2), 4)
    assert idx.count() == len(live) == 128
    assert idx.list_size == start_list_size, "churn forced list growth"
    assert int(idx._fill.sum()) - sum(len(v) for v in idx._free.values()) == 128
    q = _unit(rng, 4)
    got, _ = idx.search(q, 8, nprobe=8)
    live_ids = np.asarray(sorted(live), np.int64)
    fresh_idx = _make()
    fresh_idx.centroids = idx.centroids
    fresh_idx.upsert(live_ids, x[live_ids - 1])
    ref, _ = fresh_idx.search(q, 8, nprobe=8)
    for a, b in zip(got, ref):
        assert set(a.tolist()) == set(b.tolist())


def test_ivf_free_slots_survive_save_load(rng, tmp_path):
    idx = IVFIndex(dim=D, nlist=4, list_size=128, nprobe=4, dtype=torch.float32,
                   name="ivf_free", device="cpu")
    idx.upsert(np.arange(1, 65, dtype=np.int64), _unit(rng, 64))
    idx.delete(list(range(1, 33)))
    idx.save(tmp_path)
    idx2 = IVFIndex.load(tmp_path, name="ivf_free", device="cpu")
    assert sum(len(v) for v in idx2._free.values()) == 32
    fill_before = idx2._fill.copy()
    idx2.upsert(np.arange(100, 132, dtype=np.int64), _unit(rng, 32))
    assert 32 - int((idx2._fill - fill_before).sum()) > 0, "no tombstoned slot was reused"
    assert idx2.count() == 64


def test_ivf_materialize_after_slot_reuse_is_consistent(rng):
    idx = _make()
    idx.upsert(np.arange(1, 97, dtype=np.int64), _unit(rng, 96))
    probe = _unit(rng, 1)
    idx.upsert([500], probe)
    idx.search(probe, 4)
    m = idx.search_begin(probe, 4)
    loc = idx._loc_of[500]
    idx.delete([500])
    g = _unit(rng, 1)
    ortho = g - (g @ probe.T) * probe
    ortho /= np.linalg.norm(ortho)
    repl = None
    for a in (0.8, 0.85, 0.9, 0.95):
        cand = a * probe + np.sqrt(1 - a * a) * ortho
        if int(idx._assignments(cand)[0, 0]) == loc[0]:
            repl = cand
            break
    assert repl is not None, "no same-list replacement for this seed"
    true_cos = float((repl @ probe.T).item())
    idx.upsert([999], repl)
    assert idx._loc_of[999] == loc, "test setup: slot was not reused"
    got_ids, got_scores = m()
    for cid, s in zip(got_ids[0].tolist(), got_scores[0].tolist()):
        if cid == 999:
            assert abs(s - true_cos) < 2e-2, (s, true_cos)


def test_ivf_materialize_during_in_progress_mutation_blocks_then_retries(rng):
    idx = _make()
    x = _unit(rng, 96)
    idx.upsert(np.arange(1, 97, dtype=np.int64), x)
    probe = x[10:11]
    idx.search(probe, 4)
    m = idx.search_begin(probe, 4)
    loc = idx._loc_of[11]
    results = {}
    t = threading.Thread(target=lambda: results.setdefault("out", m()))
    with idx._lock:
        idx._ids[loc[0], loc[1]] = 777     # writer mid-mutation, epoch not bumped
        t.start()
        t.join(timeout=2.0)
        assert t.is_alive(), "materialize accepted a resolve during an in-progress mutation"
        idx._ids[loc[0], loc[1]] = 11
        idx._mut += 1
    t.join(timeout=30.0)
    assert not t.is_alive()
    got_ids, got_scores = results["out"]
    assert got_ids[0, 0] == 11 and 777 not in got_ids[0].tolist()
    assert got_scores[0, 0] == pytest.approx(1.0, abs=1e-3)


def test_search_begin_matches_search_and_empty_index():
    rng = np.random.default_rng(77)
    x = _clustered(rng, 1500, D, n_centers=8, spread=0.1)
    idx = IVFIndex(dim=D, nlist=8, list_size=256, nprobe=8, device="cpu")
    idx.train(x[:400], iters=6)
    idx.upsert(np.arange(1, 1501, dtype=np.int64), x)
    m1, m2 = idx.search_begin(x[:5], 8), idx.search_begin(x[100:103], 8)
    ids2, s2 = m2()
    ids1, s1 = m1()
    np.testing.assert_array_equal(ids1, idx.search(x[:5], 8)[0])
    np.testing.assert_array_equal(ids2, idx.search(x[100:103], 8)[0])
    empty = IVFIndex(dim=D, nlist=8, list_size=128, nprobe=4, device="cpu")
    empty.train(x[:200], iters=2)
    eids, es = empty.search_begin(x[:5], 8)()
    assert eids.shape == (5, 8) and np.all(es == -np.inf)


def test_recall_vs_oracle_and_retrain_preserves_contents():
    rng = np.random.default_rng(123)
    n, k = 4000, 10
    x = _clustered(rng, n, 128)
    ids = np.arange(5, 5 + n, dtype=np.int64)
    idx = IVFIndex(dim=128, nlist=32, list_size=256, nprobe=8, device="cpu")
    idx.train(x[:2000], iters=8)
    idx.upsert(ids, x)
    q = x[rng.integers(0, n, 8)] + 0.05 * rng.standard_normal((8, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref = ids[np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :k]]
    recall = lambda got: np.mean([len(set(a) & set(b)) / k for a, b in zip(got.tolist(), ref.tolist())])
    assert recall(idx.search(q, k)[0]) >= 0.8
    assert recall(idx.search(q, k, nprobe=32)[0]) >= 0.99
    idx.retrain(iters=4)
    assert idx.count() == n
    assert recall(idx.search(q, k, nprobe=32)[0]) >= 0.99


# ----------------------------------------------------------- nprobe tuning


@pytest.fixture(scope="module")
def ivf():
    rng = np.random.default_rng(123)
    x = _clustered(rng, 4000, 64)
    idx = IVFIndex(dim=64, nlist=32, list_size=256, nprobe=32, device="cpu")
    idx.train(x[:2000], iters=8)
    idx.upsert(np.arange(1, 4001, dtype=np.int64), x)
    return idx


class TestTuneNprobe:
    def test_tunes_below_nlist_and_meets_target(self, ivf):
        before = ivf.nprobe
        try:
            report = ivf.tune_nprobe(k=10, target_recall=0.9, sample=64, seed=0)
            assert report["applied"] and ivf.nprobe == report["nprobe"] < ivf.nlist
            assert report["sweep"][-1]["recall"] >= 0.9
        finally:
            ivf.nprobe = before

    def test_monotone_sweep_and_termination_at_target_1(self, ivf):
        before = ivf.nprobe
        try:
            report = ivf.tune_nprobe(k=10, target_recall=1.0, sample=64, seed=1)
            recalls = [s["recall"] for s in report["sweep"]]
            assert all(b >= a - 1e-9 for a, b in zip(recalls, recalls[1:]))
            q = ivf.sample_vectors(32, seed=7)
            exact, _ = ivf.search(q, 10, nprobe=ivf.nlist)
            got, _ = ivf.search(q, 10)
            assert np.mean([len(set(a) & set(b)) / 10
                            for a, b in zip(got.tolist(), exact.tolist())]) >= 0.99
        finally:
            ivf.nprobe = before

    def test_explicit_queries_path(self, ivf):
        q = _clustered(np.random.default_rng(5), 16, ivf.dim)
        report = ivf.tune_nprobe(k=5, queries=q, target_recall=0.8, apply=False)
        assert report["queries"] == 16 and not report["applied"]

    def test_empty_index_noop(self):
        report = IVFIndex(dim=32, nlist=8, list_size=128, nprobe=4, device="cpu").tune_nprobe()
        assert report["sweep"] == [] and report["queries"] == 0

    def test_unreachable_target_caps_below_exhaustive(self, ivf):
        records = []

        class _Catch(logging.Handler):
            def emit(self, record):
                records.append(record)

        handler = _Catch(level=logging.WARNING)
        tuning_mod.log.addHandler(handler)
        before = ivf.nprobe
        try:
            report = ivf.tune_nprobe(k=10, target_recall=1.01, sample=32)
            assert report["nprobe"] == report["sweep"][-1]["nprobe"] == 16
            assert report["target_met"] is False and report["recall_min"] is not None
            assert ivf.nprobe == report["nprobe"]
            assert any("autotune" in r.getMessage() for r in records)
        finally:
            ivf.nprobe = before
            tuning_mod.log.removeHandler(handler)

    def test_unreachable_fallback_is_a_measured_point_odd_nlist(self):
        rng = np.random.default_rng(7)
        x = _clustered(rng, 3000, 32, n_centers=48)
        idx = IVFIndex(dim=32, nlist=48, list_size=128, nprobe=48, device="cpu")
        idx.train(x[:1500], iters=6)
        idx.upsert(np.arange(1, 3001, dtype=np.int64), x)
        report = idx.tune_nprobe(k=10, target_recall=1.01, sample=32, apply=False)
        swept = {s["nprobe"] for s in report["sweep"]}
        assert report["nprobe"] == max(swept) == 32 and report["recall_min"] is not None

    def test_margin_and_resamples_guard_the_cliff(self, ivf):
        report = ivf.tune_nprobe(k=10, target_recall=0.9, sample=64, margin=0.03,
                                 resamples=3, apply=False)
        assert report["effective_target"] == pytest.approx(0.93) and report["resamples"] == 3
        if report["target_met"]:
            assert report["recall_min"] >= 0.93
        assert all(s["recall_min"] <= s["recall"] + 1e-9 for s in report["sweep"])

    def test_ood_guard_never_lowers_and_meets_shifted_target(self, ivf):
        plain = ivf.tune_nprobe(k=10, target_recall=0.9, sample=64, seed=0, apply=False)
        guarded = ivf.tune_nprobe(k=10, target_recall=0.9, sample=64, seed=0, apply=False,
                                  ood_guard=True)
        g = guarded["ood_guard"]
        assert guarded["nprobe"] >= plain["nprobe"] and g["start_nprobe"] == plain["nprobe"]
        assert g["guarded_nprobe"] == guarded["nprobe"]
        assert g["shifted_recall"] >= 0.9 or guarded["nprobe"] == ivf.nlist

    def test_choice_is_stable_across_resampled_seeds(self, ivf):
        picks = {ivf.tune_nprobe(k=10, target_recall=0.9, sample=64, seed=s,
                                 apply=False)["nprobe"] for s in (0, 1, 2, 3)}
        assert len(picks) == 1, picks

    def test_recorded_queries_split_into_subsets(self, ivf):
        q = _clustered(np.random.default_rng(5), 64, ivf.dim)
        report = ivf.tune_nprobe(k=5, queries=q, target_recall=0.8, apply=False)
        assert report["queries"] == 64 and report["resamples"] == 2

    def test_auto_train_with_fewer_vectors_than_nlist(self):
        x = _clustered(np.random.default_rng(3), 3, 384, n_centers=2)
        idx = IVFIndex(dim=384, nlist=8, list_size=128, nprobe=8, device="cpu")
        idx.upsert([11, 12, 13], x)
        assert idx.count() == 3
        ids, scores = idx.search(x[:1], 3)
        assert ids[0, 0] == 11 and np.isfinite(scores[0][0])


def test_tuning_picks_the_jax_nprobe_on_a_shared_index(tmp_path):
    """Both packages load the index the JAX package built and saved (so both
    sample the same tuning queries) and their tuners pick the same nprobe
    after the same sweep."""
    rng = np.random.default_rng(31)
    x = _clustered(rng, 3000, D)
    jidx = JaxIVFIndex(dim=D, nlist=32, list_size=256, nprobe=32, dtype=jnp.float32,
                       name="t_ivf")
    jidx.train(x[:1500], iters=6)
    jidx.upsert(np.arange(1, 3001, dtype=np.int64), x)
    jidx.save(tmp_path)
    jidx = JaxIVFIndex.load(tmp_path, name="t_ivf")
    tidx = IVFIndex.load(tmp_path, name="t_ivf", device="cpu")
    kw = dict(k=10, target_recall=0.9, sample=64, seed=0, apply=False)
    jrep, trep = jidx.tune_nprobe(**kw), tidx.tune_nprobe(**kw)
    assert trep["nprobe"] == jrep["nprobe"]
    assert [s["recall"] for s in trep["sweep"]] == [s["recall"] for s in jrep["sweep"]]


# ---------------------------------------------------------------- runtime


class TestRuntimeAutotune:
    def _runtime(self, tmp_path, monkeypatch, **env):
        from financial_rag_tpu_torch.config import FrameworkConfig
        from financial_rag_tpu_torch.runtime import Runtime

        for key, value in env.items():
            monkeypatch.setenv(key, value)
        return Runtime.build(FrameworkConfig.from_env(), data_dir=tmp_path, device="cpu")

    def test_runtime_tunes_after_sweep(self, tmp_path, monkeypatch):
        rt = self._runtime(tmp_path, monkeypatch, INDEX_KIND="ivf", IVF_NLIST="8",
                           IVF_NPROBE="8", IVF_AUTOTUNE_RECALL="0.9", IVF_AUTOTUNE_SAMPLE="32")
        assert all(isinstance(i, IVFIndex) for i in rt.indexes.values())
        x = _clustered(np.random.default_rng(9), 600, 384, n_centers=8)
        for idx in rt.indexes.values():
            idx.train(x, iters=4)
            idx.upsert(np.arange(1, 601, dtype=np.int64), x)
        reports = rt.tune_indexes()
        assert set(reports) == set(rt.indexes)
        for name, idx in rt.indexes.items():
            assert idx.nprobe == reports[name]["nprobe"]

    def test_runtime_feeds_recorded_queries_when_available(self, tmp_path, monkeypatch):
        rt = self._runtime(tmp_path, monkeypatch, INDEX_KIND="ivf", IVF_NLIST="8",
                           IVF_NPROBE="8", IVF_AUTOTUNE_RECALL="0.9")
        rng = np.random.default_rng(11)
        x = _clustered(rng, 600, 384, n_centers=8)
        for idx in rt.indexes.values():
            idx.train(x, iters=4)
            idx.upsert(np.arange(1, 601, dtype=np.int64), x)
        for i in range(8):
            for name in rt.indexes:
                rt.dual_encoder.cache.put(name, f"warm {i}", x[i])
        assert all(r["query_source"] == "perturbed-sample" for r in rt.tune_indexes().values())
        q = _clustered(rng, 48, 384, n_centers=8)
        for i in range(48):
            for name in rt.indexes:
                rt.dual_encoder.cache.put(name, f"real query {i}", q[i])
        for r in rt.tune_indexes().values():
            assert r["query_source"] == "recorded" and r["queries"] == 56
            assert r["resamples"] >= 2

    def test_runtime_autotune_disabled_by_default(self, tmp_path, monkeypatch):
        monkeypatch.delenv("IVF_AUTOTUNE_RECALL", raising=False)
        rt = self._runtime(tmp_path, monkeypatch)
        assert rt.tune_indexes() == {}


@pytest.fixture(scope="module")
def ivf_runtimes(tmp_path_factory):
    """The JAX runtime ingests the golden corpus into IVF indexes and saves
    them; the port's runtime is built on a copy of that data dir."""
    from test_torch_slice import CORPUS, _config, _ingest, _write_checkpoint

    from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
    from financial_rag_tpu.runtime import Runtime as JaxRuntime
    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.runtime import Runtime

    tmp = tmp_path_factory.mktemp("ivf_slice")
    mp = pytest.MonkeyPatch()
    mp.delenv("FRAG_PLATFORM", raising=False)
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
    ckpt = tmp / "ckpt"
    _write_checkpoint(ckpt / "bge", seed=1)
    _write_checkpoint(ckpt / "gte", seed=2)
    _write_checkpoint(ckpt / "ce", seed=3, classifier=True)
    src = tmp / "src"
    src.mkdir()
    for doc_id, text in CORPUS.items():
        (src / f"{doc_id}.json").write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))

    def cfg(cls):
        c = _config(cls, ckpt)
        c.index.kind = "ivf"
        c.index.ivf_nlist = 8
        c.index.ivf_nprobe = 4
        return c

    jrt = JaxRuntime.build(cfg(JaxFrameworkConfig), data_dir=tmp / "jax")
    _ingest(jrt, src)
    jrt.save_indexes(tmp / "jax")
    shutil.copytree(tmp / "jax", tmp / "port", ignore=shutil.ignore_patterns("jax_cache"))
    trt = Runtime.build(cfg(FrameworkConfig), data_dir=tmp / "port", device="cpu")
    yield jrt, trt
    mp.undo()


def test_port_runtime_reloads_the_jax_ivf_indexes(ivf_runtimes):
    jrt, trt = ivf_runtimes
    for name, idx in trt.indexes.items():
        assert isinstance(idx, IVFIndex) and idx.device == torch.device("cpu")
        assert idx.count() == jrt.indexes[name].count() > 0
        assert idx.nlist == 8 and idx.nprobe == 4


def test_ivf_runtime_answers_the_golden_questions_as_jax(ivf_runtimes):
    from test_torch_slice import GOLDEN

    jrt, trt = ivf_runtimes
    before = ivf_probe.LAUNCHES
    for question in GOLDEN:
        jout, tout = jrt.engine.query(question), trt.engine.query(question)
        assert jout["success"] and tout["success"]
        ttexts = [c["text"] for c in tout["top_children_chunks"]]
        assert ttexts and ttexts == [c["text"] for c in jout["top_children_chunks"]], question
        assert tout["answer"] == jout["answer"]
    assert ivf_probe.LAUNCHES == before     # the CPU runs the plain version
