"""IngestionPipeline.flush waits on every CUDA device that holds an index
or a shard of one, once per device.

The CPU has no CUDA device, so these tests stand a shard's storage tensor
in for one on a named card (an object with that ``device``) and count the
calls of a patched ``torch.cuda.synchronize``. The card's own case is in
tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import pytest
import torch

from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.index.ivf import IVFIndex
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline
from financial_rag_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex

CPU4 = ["cpu"] * 4


def _flat(devices=None):
    if devices is None:
        return FlatIndex(dim=8, capacity=16, device="cpu")
    return ShardedFlatIndex(devices, dim=8, capacity_per_shard=16)


def _ivf(devices=None):
    if devices is None:
        return IVFIndex(dim=8, nlist=2, list_size=8, nprobe=1, device="cpu")
    return ShardedIVFIndex(devices, dim=8, nlist=2, list_size=8, nprobe=1)


def _on_cards(index, cards):
    """Each shard's storage (one FlatIndex's or IVFIndex's tensor) stands
    on cuda:cards[i]."""
    shards = getattr(index, "shards", [index])
    for shard, card in zip(shards, cards):
        attr = "_vectors" if isinstance(shard, FlatIndex) else "_storage"
        setattr(shard, attr, SimpleNamespace(device=torch.device("cuda", card)))
    return index


@pytest.fixture
def synced(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    return calls


def _flush(**indexes):
    IngestionPipeline.flush(SimpleNamespace(indexes=indexes))


@pytest.mark.parametrize("make", [_flat, _ivf], ids=["sharded_flat", "sharded_ivf"])
def test_flush_syncs_each_shard_device_once(make, synced):
    """4 shards on 2 cards: 2 calls, one a card."""
    _flush(baai=_on_cards(make(CPU4), [0, 1, 0, 1]))
    assert sorted(synced, key=str) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_flush_syncs_a_device_once_across_collections(synced):
    """A sharded flat and a sharded IVF collection over the same 2 cards,
    and a plain index on the first: still one call a card."""
    _flush(baai=_on_cards(_flat(CPU4), [0, 1, 0, 1]), gte=_on_cards(_ivf(CPU4), [1, 0, 1, 0]),
           extra=_on_cards(_flat(), [0]))
    assert sorted(synced, key=str) == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("make", [_flat, _ivf], ids=["flat", "ivf"])
def test_flush_syncs_a_plain_index_on_a_card(make, synced):
    _flush(baai=_on_cards(make(), [1]))
    assert synced == [torch.device("cuda", 1)]


@pytest.mark.parametrize("make,devices", [(_flat, None), (_ivf, None), (_flat, CPU4),
                                          (_ivf, CPU4)],
                         ids=["flat", "ivf", "sharded_flat", "sharded_ivf"])
def test_flush_syncs_nothing_on_the_cpu(make, devices, synced):
    _flush(baai=make(devices), gte=make(devices))
    assert synced == []


@pytest.mark.parametrize("make,n", [(_flat, 1), (_ivf, 1), (_flat, 4), (_ivf, 4)],
                         ids=["flat", "ivf", "sharded_flat", "sharded_ivf"])
def test_storage_devices_name_every_shard(make, n):
    index = make(None if n == 1 else CPU4)
    assert index.storage_devices() == [torch.device("cpu")] * n
