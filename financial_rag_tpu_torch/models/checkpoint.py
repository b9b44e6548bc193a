"""Checkpoint IO: HuggingFace safetensors / npz -> the stacked parameter tree.

Counterpart of financial_rag_tpu/models/checkpoint.py. A parameter tree is a
nested dict of torch tensors in the JAX package's layout (layer weights
stacked on a leading axis, Linear weights as (in, out)), so the two packages
compute the same function from the same tree: ``params_from_numpy`` takes
the JAX package's tree as numpy arrays. ``model.safetensors`` is read by a
small reader of this module's own (8-byte header length, JSON header, raw
little-endian bytes), so no ``safetensors`` package is needed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("models.checkpoint")


def _is_lfs_stub(path: Path) -> bool:
    try:
        if path.stat().st_size > 1024:
            return False
        head = path.read_bytes()[:64]
        return head.startswith(b"version https://git-lfs")
    except OSError:
        return True


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Mapping[str, Any], *, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nested dicts of array-likes (e.g. ``np.asarray`` over the JAX
    package's parameter pytree) -> the port's tree of tensors."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           dtype=dtype, device=device), tree)


def random_params(config: ModelConfig, seed: int = 0,
                  dtype: torch.dtype = torch.float32, device="cpu") -> Dict[str, Any]:
    """BERT-style normal(0.02) init from numpy, deterministic in `seed`:
    the same draws, in the same order, as the JAX package's random_params."""
    rng = np.random.default_rng(seed)
    h, i_sz, nl = config.hidden_size, config.intermediate_size, config.num_layers

    def tn(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    params: Dict[str, Any] = {
        "embeddings": {
            "word": tn(config.vocab_size, h),
            "position": tn(config.max_position, h),
            "token_type": tn(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "q_w": tn(nl, h, h), "q_b": zeros(nl, h),
            "k_w": tn(nl, h, h), "k_b": zeros(nl, h),
            "v_w": tn(nl, h, h), "v_b": zeros(nl, h),
            "o_w": tn(nl, h, h), "o_b": zeros(nl, h),
            "attn_ln_scale": ones(nl, h), "attn_ln_bias": zeros(nl, h),
            "ffn_in_w": tn(nl, h, i_sz), "ffn_in_b": zeros(nl, i_sz),
            "ffn_out_w": tn(nl, i_sz, h), "ffn_out_b": zeros(nl, h),
            "ffn_ln_scale": ones(nl, h), "ffn_ln_bias": zeros(nl, h),
        },
        "pooler": {"w": tn(h, h), "b": zeros(h)},
    }
    if config.num_labels:
        params["classifier"] = {"w": tn(h, config.num_labels), "b": zeros(config.num_labels)}
    return params_from_numpy(params, device=device, dtype=dtype)


def params_from_torch_state_dict(
    sd: Mapping[str, Any], config: ModelConfig, dtype: torch.dtype = torch.float32
) -> Dict[str, Any]:
    """Convert an HF BertModel / BertForSequenceClassification state dict
    (torch tensors or numpy arrays) into the stacked parameter tree."""

    def arr(t) -> np.ndarray:
        return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach") else t,
                          np.float32)

    def get(name: str) -> np.ndarray:
        for key in (name, f"bert.{name}"):
            if key in sd:
                return arr(sd[key])
        raise KeyError(f"missing checkpoint tensor: {name}")

    nl = config.num_layers

    def stack_linear(fmt: str):
        """Stack per-layer torch Linear weights, transposed to (in, out)."""
        return np.stack([get(fmt.format(i)).T for i in range(nl)])

    def stack_vec(fmt: str):
        return np.stack([get(fmt.format(i)) for i in range(nl)])

    p = "encoder.layer.{}."
    params: Dict[str, Any] = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": {
            "q_w": stack_linear(p + "attention.self.query.weight"),
            "q_b": stack_vec(p + "attention.self.query.bias"),
            "k_w": stack_linear(p + "attention.self.key.weight"),
            "k_b": stack_vec(p + "attention.self.key.bias"),
            "v_w": stack_linear(p + "attention.self.value.weight"),
            "v_b": stack_vec(p + "attention.self.value.bias"),
            "o_w": stack_linear(p + "attention.output.dense.weight"),
            "o_b": stack_vec(p + "attention.output.dense.bias"),
            "attn_ln_scale": stack_vec(p + "attention.output.LayerNorm.weight"),
            "attn_ln_bias": stack_vec(p + "attention.output.LayerNorm.bias"),
            "ffn_in_w": stack_linear(p + "intermediate.dense.weight"),
            "ffn_in_b": stack_vec(p + "intermediate.dense.bias"),
            "ffn_out_w": stack_linear(p + "output.dense.weight"),
            "ffn_out_b": stack_vec(p + "output.dense.bias"),
            "ffn_ln_scale": stack_vec(p + "output.LayerNorm.weight"),
            "ffn_ln_bias": stack_vec(p + "output.LayerNorm.bias"),
        },
    }
    try:
        params["pooler"] = {"w": get("pooler.dense.weight").T, "b": get("pooler.dense.bias")}
    except KeyError:
        pass
    if "classifier.weight" in sd:
        params["classifier"] = {"w": arr(sd["classifier.weight"]).T,
                                "b": arr(sd["classifier.bias"])}
    return params_from_numpy(params, dtype=dtype)


_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """Read every tensor of a ``.safetensors`` file into numpy (BF16 is
    widened to float32)."""
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        buf = raw[base + lo: base + hi]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif info["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(buf, dtype=dt).reshape(shape)
        else:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']}")
    return out


def load_params(
    model_dir: str | Path,
    config: Optional[ModelConfig] = None,
    *,
    dtype: torch.dtype = torch.float32,
    fallback_seed: Optional[int] = None,
):
    """Load params from a model directory holding model.safetensors (HF
    names) or model.npz (this layout, see save_params_npz) plus config.json.

    Returns (params, config). If the weights are a git-LFS pointer stub or
    missing and fallback_seed is given, returns seeded random params."""
    model_dir = Path(model_dir)
    if config is None:
        config = ModelConfig.from_json(model_dir)
    st_path = model_dir / "model.safetensors"

    if st_path.exists() and not _is_lfs_stub(st_path):
        sd = read_safetensors(st_path)
        log.info("loaded %d tensors from %s", len(sd), st_path)
        return params_from_torch_state_dict(sd, config, dtype=dtype), config

    npz_path = model_dir / "model.npz"
    if npz_path.exists():
        log.info("loaded params from %s", npz_path)
        return load_params_npz(npz_path, dtype=dtype), config

    if fallback_seed is not None:
        log.warning("weights at %s unavailable (LFS stub or missing); using seeded random init", st_path)
        return random_params(config, seed=fallback_seed, dtype=dtype), config
    raise FileNotFoundError(f"no usable weights at {st_path} (LFS stub or missing)")


def save_params_npz(params: Dict[str, Any], path: str | Path) -> None:
    """Flatten the tree into an .npz archive, names joined by '/' (the
    JAX package's save_params_npz naming)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = node.detach().cpu().float().numpy()

    walk(params, "")
    np.savez(path, **flat)


def load_params_npz(path: str | Path, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    data = np.load(path)
    params: Dict[str, Any] = {}
    for name in data.files:
        node = params
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.tensor(np.asarray(data[name], np.float32), dtype=dtype)
    return params
