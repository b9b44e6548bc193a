"""Runtime factory: assemble the served stack from configuration.

Counterpart of financial_rag_tpu/runtime.py for the configurations the
port serves: one device or several; per-model flat indexes (bf16, f32 or int8,
``INDEX_DTYPE``) or IVF indexes (``INDEX_KIND=ivf``, with the nprobe
auto-tune of ``tune_indexes``); the dual bge/gte encoders (real checkpoints
when available, the deterministic lexical fallback otherwise); the
cross-encoder rerank; the parent stores; the HTTP/Null LLM provider or the
on-device decoder (``LLM_PROVIDER=local``, on the runtime's device); the
auto-ingest processor (``make_processor``), the WSGI app (``make_app``) and
the warmups. With ``SERVE_MICROBATCH`` on (the default) it wires the JAX
runtime's cross-request micro-batching (serving/batcher.py): one shared
``ActiveCount``, a ``BatchingEncoder`` per device-backed encoder, one
``MultiIndexBatcher`` over every index with a raw-encoder chained-wave
lane, a ``BatchingCrossEncoder`` around the reranker and a ``BatchingLLM``
around a provider with ``generate_many``. ``INDEX_SHARDS`` > 1 shards
each collection over that many devices (``ShardedFlatIndex``, or
``ShardedIVFIndex`` with ``INDEX_KIND=ivf``) and ``ENCODE_DP`` > 1 encodes
data-parallel, as the JAX runtime does; where the machine has fewer GPUs,
shards and replicas wrap onto them (``parallel.mesh.search_devices``). On
CUDA, checkpoint widths the kernels are not built for raise
NotImplementedError at build.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import torch

from financial_rag_tpu_torch.config import FrameworkConfig, ModelConfig
from financial_rag_tpu_torch.device import DeviceLike, resolve_device
from financial_rag_tpu_torch.engine import RAGEngine
from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.index.ivf import IVFIndex, recommended_nlist
from financial_rag_tpu_torch.index.persist import STR_TO_DTYPE
from financial_rag_tpu_torch.ingest.ledger import ProcessingLedger
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline, collection_slug
from financial_rag_tpu_torch.llm.provider import get_provider
from financial_rag_tpu_torch.models.encoder import DualEncoder, Encoder
from financial_rag_tpu_torch.models.hashing import HashingEncoder
from financial_rag_tpu_torch.models.decoder import DecoderConfig
from financial_rag_tpu_torch.ops import causal_flash, flash_attention, fused_ffn, topk
from financial_rag_tpu_torch.ops.common import built_head_dim
from financial_rag_tpu_torch.parallel import (ShardedFlatIndex, ShardedIVFIndex, encode_devices,
                                              search_devices)
from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever
from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderModel, CrossEncoderReranker
from financial_rag_tpu_torch.retrieval.retriever import ParentContextRetriever
from financial_rag_tpu_torch.store import ChildMetaStore, ParentStore
from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase
from financial_rag_tpu_torch.utils import get_logger
from financial_rag_tpu_torch.utils.embed_cache import EmbeddingCache
from financial_rag_tpu_torch.utils.tracing import QueryTracer

log = get_logger("runtime")

POOLING_BY_MODEL = {"baai": "cls", "gte": "mean"}  # true checkpoint behavior


def _ivf_list_size(capacity: int, nlist: int) -> int:
    """Initial posting-list size: 2x the even split of capacity, clamped to
    [128, 4096] (lists grow on demand, so the cap only bounds the initial
    allocation)."""
    return min(max(capacity // max(nlist, 1) * 2, 128), 4096)


def check_supported(cfg: FrameworkConfig, device: torch.device) -> None:
    """Raise NotImplementedError on CUDA for checkpoint widths the kernels
    are not built for."""
    if device.type == "cuda":
        check_kernel_widths(cfg)


def _checkpoint_config(path: Optional[str]) -> Optional[ModelConfig]:
    """The config.json of a checkpoint directory the runtime would load, or
    None where it would serve the 384-wide lexical fallback instead."""
    if path and (Path(path) / "config.json").exists():
        return ModelConfig.from_json(path)
    return None


def check_kernel_widths(cfg: FrameworkConfig) -> None:
    """The CUDA path runs every encoder and reranker layer through K2 and
    K3, a bf16 or int8 flat index through K4-K7 (a sharded one through
    K7), and a local LLM's every prefill through K9, which take the widths
    up to their limits (head_dim up to 64, zero-padded to 32 or 64; hidden
    and intermediate multiples of 8; D up to 1,024; the decoder's head_dim
    up to 128, zero-padded to 64 or 128); the JAX package and the CPU take
    any. Raise NotImplementedError at build, naming each kernel and its
    limit, rather than on the first encode, search or prefill (a K9 refusal
    there would be swallowed by the provider's degrade path, and every
    answer would be the no-LLM text). (K6, which takes D <= 384, serves
    only a FlatIndex built with backend ``pallas_exact``, never the
    runtime's; that index refuses wider rows itself.)"""
    models = {"baai": cfg.encoders.baai_path, "gte": cfg.encoders.gte_path}
    if cfg.rerank.enabled:
        models["reranker"] = cfg.rerank.model_path
    flat_sweep = cfg.index.kind != "ivf" and cfg.index.dtype in ("bfloat16", "int8")
    # a sharded flat index sweeps through K7 alone; one device's through K4 or K5
    sharded = cfg.mesh.index_shards > 1
    max_d = topk.SWEEP_MAX_D if sharded else min(topk.PACKED_MAX_D, topk.SWEEP_MAX_D)
    sweeps = "K7" if sharded else "K4-K7"
    problems = []
    for name, path in models.items():
        mc = _checkpoint_config(path)
        if mc is None:
            continue
        if (mc.hidden_size % mc.num_heads
                or built_head_dim(mc.hidden_size // mc.num_heads, flash_attention.FWD_HEAD_DIMS) is None):
            problems.append(f"{name}: head_dim {mc.hidden_size / mc.num_heads:g}, but "
                            f"flash_attention (K2) takes head_dim <= "
                            f"{flash_attention.FWD_HEAD_DIMS[-1]}")
        if not fused_ffn.kernel_takes(mc.hidden_size, mc.intermediate_size):
            problems.append(f"{name}: hidden {mc.hidden_size} / intermediate "
                            f"{mc.intermediate_size}, but fused_ffn (K3) takes hidden and "
                            f"intermediate multiples of {fused_ffn.GENERIC_GRANULE}")
        if name != "reranker" and flat_sweep and mc.hidden_size > max_d:
            problems.append(f"{name}: index dim {mc.hidden_size}, but the {cfg.index.dtype} "
                            f"flat sweeps ({sweeps}) take D <= {max_d}")
    llm_dir = Path(cfg.llm.local_checkpoint or "")
    if cfg.llm.provider == "local" and cfg.llm.local_checkpoint and (llm_dir / "config.json").exists():
        dc = DecoderConfig.from_hf_config(json.loads((llm_dir / "config.json").read_text()))
        if (dc.hidden_size % dc.num_heads
                or built_head_dim(dc.head_dim, causal_flash.KERNEL_HEAD_DIMS) is None):
            problems.append(f"local LLM: head_dim {dc.hidden_size / dc.num_heads:g}, but "
                            f"causal_flash_prefill (K9) takes head_dim <= "
                            f"{causal_flash.KERNEL_HEAD_DIMS[-1]}")
    if problems:
        raise NotImplementedError("the CUDA kernels are not built for these widths: "
                                  + "; ".join(problems))


def _build_encoder(name: str, path: Optional[str], pooling: str, cfg: FrameworkConfig,
                   device: torch.device):
    if path and Path(path).exists():
        try:
            enc = Encoder.from_pretrained(
                path, pooling=pooling,
                batch_size=cfg.encoders.encode_batch_size,
                max_seq_len=cfg.encoders.max_seq_len,
                device=device, replicas=encode_devices(cfg.mesh.encode_dp, device))
            log.info("encoder %s: loaded checkpoint from %s", name, path)
            return enc
        except FileNotFoundError as e:
            log.warning("encoder %s: %s", name, e)
    log.warning("encoder %s: no usable checkpoint; using deterministic "
                "lexical fallback encoder", name)
    return HashingEncoder(dim=384, salt=hash(name) & 0xFFFF)


@dataclass
class Runtime:
    config: FrameworkConfig
    dual_encoder: DualEncoder
    indexes: Dict[str, object]          # a flat, IVF or sharded index per model
    parent_store: ParentStore
    child_meta: ChildMetaStore
    feedback_db: FeedbackDatabase
    pipeline: IngestionPipeline
    hybrid: HybridRetriever
    dense_retriever: ParentContextRetriever
    engine: RAGEngine
    ledger: ProcessingLedger
    device: torch.device
    # serializes whole index checkpoints (save_indexes docstring)
    _save_lock: threading.Lock = field(default_factory=threading.Lock,
                                       init=False, repr=False)

    @classmethod
    def build(cls, config: Optional[FrameworkConfig] = None,
              data_dir: str | Path = ".", device: DeviceLike = None) -> "Runtime":
        """``device``: the argument, else FRAG_PLATFORM (``cpu``), else
        ``cuda``; a CUDA device without CUDA raises."""
        device = resolve_device(device)
        cfg = config or FrameworkConfig.from_env()
        check_supported(cfg, device)
        data_dir = Path(data_dir)
        data_dir.mkdir(parents=True, exist_ok=True)

        encoders = {
            "baai": _build_encoder("baai", cfg.encoders.baai_path, "cls", cfg, device),
            "gte": _build_encoder("gte", cfg.encoders.gte_path, "mean", cfg, device),
        }
        raw_encoders = dict(encoders)   # unwrapped: the chained wave lane
        serve_active = None
        if cfg.serving.microbatch:
            from financial_rag_tpu_torch.serving.batcher import ActiveCount, BatchingEncoder

            # ONE concurrency gauge shared by every batcher of this runtime
            # (encode x2, fused sweep, rerank, llm): the direct-lane policy
            # gates on system-wide active requests (ActiveCount docstring)
            serve_active = ActiveCount()
            # wrap only device-backed encoders: a host-side fallback encoder
            # behind the batcher would serialize all request threads
            encoders = {
                name: (BatchingEncoder(enc, max_texts=cfg.serving.microbatch_max,
                                       max_wait_ms=cfg.serving.microbatch_wait_ms,
                                       direct=cfg.serving.microbatch_direct,
                                       active=serve_active,
                                       name=f"encode-{name}")
                       if getattr(enc, "device_backed", False) else enc)
                for name, enc in encoders.items()
            }
            n_wrapped = sum(isinstance(e, BatchingEncoder) for e in encoders.values())
            log.info("micro-batching enabled: wait=%.1fms max=%d direct<=%d "
                     "(%d/%d encoders wrapped; host-side fallback encoders "
                     "are served unbatched)",
                     cfg.serving.microbatch_wait_ms, cfg.serving.microbatch_max,
                     cfg.serving.microbatch_direct, n_wrapped, len(encoders))
        embed_cache = EmbeddingCache(max_items=4096)
        dual = DualEncoder(encoders, fused_weights=cfg.encoders.fused_weights,
                           cache=embed_cache)

        # INDEX_SHARDS > 1 shards each collection over that many devices
        shards = cfg.mesh.index_shards
        devices = search_devices(shards, device) if shards > 1 else None
        persist = data_dir / cfg.index.persist_dir
        index_dtype = STR_TO_DTYPE.get(cfg.index.dtype, torch.bfloat16)
        indexes: Dict[str, object] = {}
        for name in dual.names:
            coll = collection_slug(getattr(cfg.encoders, f"{name}_name", name))
            dim = getattr(encoders[name], "dim", cfg.index.dim)
            if shards > 1 and cfg.index.kind == "ivf":
                # the 10M-chunk configuration: one IVF partition per device,
                # round-robin routing, a host merge
                sname = f"{coll}_ivf_sharded"
                nlist = (cfg.index.ivf_nlist
                         or recommended_nlist(cfg.index.planned_capacity // shards))
                if (persist / f"{sname}_0.manifest.json").exists():
                    indexes[name] = ShardedIVFIndex.load(persist, devices, name=sname)
                    log.info("sharded ivf index %s: reloaded %d vectors",
                             coll, indexes[name].count())
                else:
                    indexes[name] = ShardedIVFIndex(
                        devices, dim=dim, nlist=nlist,
                        list_size=_ivf_list_size(cfg.index.planned_capacity // shards, nlist),
                        nprobe=cfg.index.ivf_nprobe, dtype=index_dtype, name=sname)
                    log.info("index %s: IVF sharded over %d devices", coll, shards)
            elif shards > 1:
                if (persist / f"{coll}.manifest.json").exists():
                    indexes[name] = ShardedFlatIndex.load(persist, devices, name=coll,
                                                          dtype=index_dtype)
                    log.info("sharded index %s: reloaded %d vectors over %d devices",
                             coll, indexes[name].count(), shards)
                else:
                    indexes[name] = ShardedFlatIndex(
                        devices, dim=dim,
                        capacity_per_shard=max(cfg.index.planned_capacity // shards, 1024),
                        dtype=index_dtype, name=coll)
                    log.info("index %s: sharded over %d devices", coll, shards)
            elif cfg.index.kind == "ivf":
                nlist = cfg.index.ivf_nlist or recommended_nlist(cfg.index.planned_capacity)
                if (persist / f"{coll}_ivf.manifest.json").exists():
                    indexes[name] = IVFIndex.load(persist, name=f"{coll}_ivf",
                                                  dtype=index_dtype, device=device)
                    log.info("ivf index %s: reloaded %d vectors", coll,
                             indexes[name].count())
                else:
                    indexes[name] = IVFIndex(
                        dim=dim, nlist=nlist,
                        list_size=_ivf_list_size(cfg.index.planned_capacity, nlist),
                        nprobe=cfg.index.ivf_nprobe, dtype=index_dtype,
                        name=f"{coll}_ivf", device=device)
            elif (persist / f"{coll}.npz").exists():
                indexes[name] = FlatIndex.load(persist, name=coll, dtype=index_dtype,
                                               device=device)
                log.info("index %s: reloaded %d vectors", coll, indexes[name].count())
            else:
                # capacity=0 (auto): start at one kernel tile and double on
                # demand — the sweep streams the WHOLE allocation
                cap = cfg.index.capacity or 1024
                indexes[name] = FlatIndex(dim=dim, capacity=cap, dtype=index_dtype,
                                          name=coll, device=device)

        # cross-request sweep batching happens at the hybrid level: one
        # MultiIndexBatcher over every per-model index (one fused sweep and
        # one device-to-host copy per batch across both models); the
        # indexes stay raw for ingest and admin callers
        sweep_batcher = None
        if cfg.serving.microbatch:
            from financial_rag_tpu_torch.serving.batcher import MultiIndexBatcher

            # chain_encoder: RAW encoders sharing the serving embedding
            # cache; coalesced waves encode their texts themselves and feed
            # the device output into the sweeps (search_texts)
            sweep_batcher = MultiIndexBatcher(
                indexes, max_queries=cfg.serving.microbatch_max,
                max_wait_ms=cfg.serving.microbatch_wait_ms,
                inflight=cfg.serving.microbatch_inflight,
                direct=cfg.serving.microbatch_direct,
                active=serve_active,
                chain_encoder=DualEncoder(raw_encoders, cache=embed_cache))

        parent_store = ParentStore(data_dir / cfg.store.parents_db_path)
        child_meta = ChildMetaStore(data_dir / "children_meta.db")
        feedback_db = FeedbackDatabase(data_dir / cfg.store.feedback_db_path,
                                       cache_ttl_s=cfg.serving.result_cache_ttl_s)
        llm = get_provider(cfg.llm, device=device)
        if cfg.serving.microbatch and hasattr(llm, "generate_many"):
            # concurrent answer generations coalesce into one batched
            # decode; concurrent streams join the continuous engine
            from financial_rag_tpu_torch.serving.batcher import BatchingLLM

            llm = BatchingLLM(llm, max_items=8,
                              max_wait_ms=cfg.serving.microbatch_wait_ms,
                              direct=cfg.serving.microbatch_direct,
                              active=serve_active)

        reranker_model = None
        if cfg.rerank.enabled and cfg.rerank.model_path and Path(cfg.rerank.model_path).exists():
            try:
                reranker_model = CrossEncoderModel.from_pretrained(cfg.rerank.model_path,
                                                                   device=device)
                log.info("reranker: loaded %s", cfg.rerank.model_path)
            except (FileNotFoundError, ValueError) as e:
                log.warning("reranker unavailable (%s); falling back to retrieval sort", e)
        if reranker_model is not None and cfg.serving.microbatch:
            from financial_rag_tpu_torch.serving.batcher import BatchingCrossEncoder

            # 128-pair fused cap, as the JAX runtime sets it
            reranker_model = BatchingCrossEncoder(
                reranker_model, max_pairs=128,
                max_wait_ms=cfg.serving.microbatch_wait_ms,
                direct=cfg.serving.microbatch_direct,
                active=serve_active)
        reranker = CrossEncoderReranker(reranker_model, cfg.rerank)

        pipeline = IngestionPipeline(
            dual, parent_store, child_meta, indexes,
            llm=llm,
            chunk_logs_dir=data_dir / cfg.ingest.chunk_logs_dir,
            chunk_context_enabled=cfg.llm.chunk_context_enabled)
        hybrid = HybridRetriever(dual, indexes, child_meta,
                                 fusion_cfg=cfg.fusion, retrieval_cfg=cfg.retrieval,
                                 llm=llm, sweep_batcher=sweep_batcher)
        dense = ParentContextRetriever(dual, indexes, parent_store, child_meta,
                                       rrf_k=cfg.fusion.rrf_k)
        engine = RAGEngine(hybrid, parent_store, reranker, llm, config=cfg,
                           feedback_db=feedback_db,
                           tracer=QueryTracer(data_dir / cfg.store.trace_dir),
                           active=serve_active)
        ledger = ProcessingLedger(data_dir / cfg.ingest.state_path)

        return cls(config=cfg, dual_encoder=dual, indexes=indexes,
                   parent_store=parent_store, child_meta=child_meta,
                   feedback_db=feedback_db, pipeline=pipeline, hybrid=hybrid,
                   dense_retriever=dense, engine=engine, ledger=ledger, device=device)

    def tune_indexes(self) -> Dict[str, dict]:
        """Auto-tune IVF nprobe on every tunable index (no-op for flat
        indexes and when IVF_AUTOTUNE_RECALL is unset). Returns per-index
        tuning reports; the tuned nprobe persists via the index manifest."""
        target = self.config.index.ivf_autotune_recall
        if target <= 0:
            return {}
        reports: Dict[str, dict] = {}
        cache = self.dual_encoder.cache
        for name, idx in self.indexes.items():
            if hasattr(idx, "tune_nprobe") and idx.count() and idx.is_trained:
                # in-distribution tuning: recorded real query vectors from
                # the serving embedding cache when enough have been seen
                # (>= 32 so the per-sample split stays meaningful);
                # perturbed stored vectors otherwise
                recorded = cache.recent_queries(name) if cache is not None else None
                if recorded is not None and len(recorded) < 32:
                    recorded = None
                reports[name] = idx.tune_nprobe(
                    target_recall=target, queries=recorded,
                    sample=self.config.index.ivf_autotune_sample,
                    ood_guard=self.config.index.ivf_tune_ood_guard)
                reports[name]["query_source"] = (
                    "recorded" if recorded is not None else "perturbed-sample")
                log.info("index %s: tuned nprobe=%d (%s queries)", name,
                         reports[name]["nprobe"], reports[name]["query_source"])
        return reports

    def save_indexes(self, data_dir: str | Path = ".") -> None:
        # serialize whole checkpoints: each FILE is atomic (persist.py);
        # this lock makes the npz + manifest PAIR consistent
        with self._save_lock:
            persist = Path(data_dir) / self.config.index.persist_dir
            for idx in self.indexes.values():
                idx.save(persist)
            log.info("persisted %d indexes to %s", len(self.indexes), persist)

    def make_processor(self, data_dir: str | Path = "."):
        from financial_rag_tpu_torch.serving.processor import DocumentProcessor

        data_dir = Path(data_dir)
        return DocumentProcessor(
            self.pipeline, self.ledger,
            source_dir=data_dir / self.config.ingest.source_dir,
            extracted_dir=data_dir / self.config.ingest.extracted_dir,
            on_sweep_complete=lambda: (self.tune_indexes(),
                                       self.save_indexes(data_dir),
                                       self.warm_sweeps()))

    def warm_sweeps(self) -> None:
        """After ingest: the sweep batcher's shapes (direct bucket + max
        batch, and the chained waves at the 64 and 128 sequence buckets),
        then the rerank and the LLM warmups (each skipped without its
        batcher or provider, as in the JAX runtime)."""
        if self.hybrid.sweep_batcher is not None:
            try:
                self.hybrid.sweep_batcher.warmup(self.config.fusion.per_query_k)
            except Exception:  # noqa: BLE001 — warmup must never break ingest
                log.exception("sweep warmup failed")
        self._warm_rerank()
        self._warm_llm()

    def _warm_llm(self) -> None:
        """Run the on-device answer paths ONCE (``LocalLLM.warm``: prefill
        at the 5-parent prompt bucket, the streaming and one-shot decode),
        so the first answer request does not pay the checkpoint load and
        the first launches; a no-op for providers without ``warm``."""
        if getattr(self, "_llm_warmed", False):
            return
        warm = getattr(self.engine.llm, "warm", None)
        if warm is None:
            return
        try:
            if warm():
                self._llm_warmed = True
        except Exception:  # noqa: BLE001 — warmup must never break ingest
            log.exception("llm warmup failed")

    def _warm_rerank(self) -> None:
        """Run the rerank forward at the coalesced pair-batch size, using
        REAL corpus snippets so the sequence bucket matches serving traffic.
        No-op without a batching cross-encoder or a corpus."""
        model = getattr(self.engine.reranker, "model", None)
        if model is None or not hasattr(model, "batcher"):
            return
        try:
            sample = self.child_meta.sample_snippets(8)
            if not sample:
                return
            pairs = [("representative warmup question about amounts", s)
                     for s in sample]
            reps = (len(sample) - 1 + model.batcher.max_items) // len(sample)
            inner = model.inner
            inner.predict((pairs * reps)[: model.batcher.max_items])
            inner.predict(pairs * 3)   # the per-request (direct-lane) size
        except Exception:  # noqa: BLE001 — warmup must never break ingest
            log.exception("rerank warmup failed")

    def make_app(self, processor=None, data_dir: str | Path = "."):
        from financial_rag_tpu_torch.serving.app import create_app

        return create_app(self.engine, processor=processor, config=self.config,
                          source_dir=str(Path(data_dir) / self.config.ingest.source_dir),
                          on_save=lambda: self.save_indexes(data_dir))
