"""The port's BERT stack and checkpoint IO against the JAX package.

Both packages get the same random parameters (the JAX tree as numpy, through
``params_from_numpy``) and the same token batches; the JAX side runs its XLA
path on the CPU, the port its plain versions.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models import bert as jbert
from financial_rag_tpu.models import checkpoint as jckpt
from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.models import bert, checkpoint

torch.set_num_threads(2)

SMALL = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
             vocab_size=30522, max_position=512)


def _configs(**extra):
    return JaxModelConfig(**SMALL, **extra), ModelConfig(**SMALL, **extra)


def _tree_np(params):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in params.items()}


def _batch(seed=0, b=6, s=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 30000, size=(b, s)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((b, s), np.int32)
    mask[1, 17:] = 0
    mask[3, 40:] = 0
    mask[5, 1:] = 0
    types = np.zeros((b, s), np.int32)
    types[:, 30:] = 1
    return ids, mask, types


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def encoder_params():
    jcfg, tcfg = _configs()
    jp = jckpt.random_params(jcfg, seed=11)
    return jcfg, tcfg, jp, checkpoint.params_from_numpy(_tree_np(jp))


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bert_encode_matches_jax(encoder_params, pooling):
    jcfg, tcfg, jp, tp = encoder_params
    ids, mask, _ = _batch()
    ref = np.asarray(jbert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), config=jcfg,
                                       pooling=pooling, attention_impl="xla"))
    out = bert.bert_encode(bert.prepare_params(tp, device="cpu", compute_dtype=torch.float32),
                           torch.from_numpy(ids), torch.from_numpy(mask), config=tcfg,
                           pooling=pooling).numpy()
    assert out.shape == ref.shape == (6, 64)
    assert _cos(out, ref).min() > 0.9999
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


def test_bert_forward_hidden_matches_jax(encoder_params):
    jcfg, tcfg, jp, tp = encoder_params
    ids, mask, types = _batch(seed=1)
    ref = np.asarray(jbert.bert_forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                                        jnp.asarray(types), config=jcfg))
    out = bert.bert_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.from_numpy(types), config=tcfg).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_cross_encoder_logits_match_jax():
    jcfg, tcfg = _configs(num_labels=1)
    jp = jckpt.random_params(jcfg, seed=12)
    tp = checkpoint.params_from_numpy(_tree_np(jp))
    ids, mask, types = _batch(seed=2)
    ref = np.asarray(jbert.cross_encoder_forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                                                 jnp.asarray(types), config=jcfg))
    out = bert.cross_encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                     torch.from_numpy(types), config=tcfg).numpy()
    assert out.shape == ref.shape == (6,)
    np.testing.assert_allclose(out, ref, atol=5e-3)


def test_random_params_same_draws_as_jax():
    jcfg, tcfg = _configs(num_labels=1)
    ref = _tree_np(jckpt.random_params(jcfg, seed=3))
    out = checkpoint.random_params(tcfg, seed=3)
    assert ref.keys() == out.keys()
    for group in ref:
        for name in ref[group]:
            np.testing.assert_array_equal(out[group][name].numpy(), ref[group][name])


def _hf_state_dict(cfg: ModelConfig, seed: int, classifier: bool):
    """A random HF BertModel-style state dict (torch Linear layout)."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sd = {
        "embeddings.word_embeddings.weight": r(cfg.vocab_size, h),
        "embeddings.position_embeddings.weight": r(cfg.max_position, h),
        "embeddings.token_type_embeddings.weight": r(2, h),
        "embeddings.LayerNorm.weight": r(h), "embeddings.LayerNorm.bias": r(h),
        "embeddings.position_ids": np.arange(cfg.max_position, dtype=np.int64)[None],
        "pooler.dense.weight": r(h, h), "pooler.dense.bias": r(h),
    }
    for layer in range(cfg.num_layers):
        p = f"encoder.layer.{layer}."
        for name, shape in [("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (i, h)), ("output.dense", (h, i))]:
            sd[p + name + ".weight"] = r(*shape)
            sd[p + name + ".bias"] = r(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = r(h)
            sd[p + ln + ".bias"] = r(h)
    if classifier:
        sd = {f"bert.{k}": v for k, v in sd.items()}
        sd["classifier.weight"] = r(1, h)
        sd["classifier.bias"] = r(1)
    return sd


def _write_config(d, cfg: ModelConfig, classifier: bool):
    raw = {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
           "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.max_position,
           "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    if classifier:
        raw.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"})
    (d / "config.json").write_text(json.dumps(raw))


def _assert_same_tree(port_tree, jax_tree):
    ref = _tree_np(jax_tree)
    assert port_tree.keys() == ref.keys()
    for group in ref:
        assert port_tree[group].keys() == ref[group].keys()
        for name in ref[group]:
            np.testing.assert_array_equal(port_tree[group][name].numpy(), ref[group][name])


@pytest.mark.parametrize("classifier", [False, True], ids=["encoder", "cross_encoder"])
def test_load_params_safetensors_matches_jax(tmp_path, classifier):
    from safetensors.numpy import save_file

    _, tcfg = _configs()
    _write_config(tmp_path, tcfg, classifier)
    save_file(_hf_state_dict(tcfg, seed=4, classifier=classifier),
              str(tmp_path / "model.safetensors"))
    jp, jcfg = jckpt.load_params(tmp_path)
    tp, cfg = checkpoint.load_params(tmp_path)
    assert (cfg.num_layers, cfg.num_labels) == (jcfg.num_layers, jcfg.num_labels)
    _assert_same_tree(tp, jp)


def test_read_safetensors_bf16_and_f16(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(5)
    tensors = {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)).to(torch.bfloat16),
               "b": torch.from_numpy(rng.standard_normal(9).astype(np.float32)).to(torch.float16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    save_file(tensors, str(tmp_path / "t.safetensors"))
    got = checkpoint.read_safetensors(tmp_path / "t.safetensors")
    for name, t in tensors.items():
        np.testing.assert_array_equal(got[name], t.float().numpy() if t.is_floating_point()
                                      else t.numpy())


def test_npz_checkpoints_load_in_both_packages(tmp_path):
    jcfg, tcfg = _configs(num_labels=1)
    jp = jckpt.random_params(jcfg, seed=6)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    for d in ("jax", "port"):
        _write_config(tmp_path / d, tcfg, classifier=True)
    jckpt.save_params_npz(jp, tmp_path / "jax" / "model.npz")
    checkpoint.save_params_npz(checkpoint.params_from_numpy(_tree_np(jp)),
                               tmp_path / "port" / "model.npz")
    port_from_jax, _ = checkpoint.load_params(tmp_path / "jax")
    _assert_same_tree(port_from_jax, jp)
    jax_from_port, _ = jckpt.load_params(tmp_path / "port")
    _assert_same_tree(checkpoint.params_from_numpy(_tree_np(jax_from_port)), jp)
