"""The port's native C++ components (financial_rag_tpu_torch/native) on the CPU.

The cases of tests/test_native.py on the port's loader (exact parity with
the pure-Python paths), then the port against the JAX package's native
library: the same WordPiece ids (non-ASCII and special-literal texts take
the Python path in both), BM25 scores within 1e-6, the same chunker word
starts. The library is built from this package's sources into
``build/native/`` and never read from the JAX package's directory.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from financial_rag_tpu import native as jnative
from financial_rag_tpu.ingest import chunker as jchunker
from financial_rag_tpu.tokenizer import WordPieceTokenizer as JaxWordPieceTokenizer
from financial_rag_tpu_torch import native
from financial_rag_tpu_torch.ingest import chunker as tchunker
from financial_rag_tpu_torch.retrieval import bm25 as tbm25
from financial_rag_tpu_torch.retrieval.bm25 import BM25
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.tokenizer.vocab import inverse_vocab, load_vocab

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _needs_the_library():
    """Decided per test, not at import: loading builds the library."""
    if not native.available():
        pytest.skip("native library not built (no C++ toolchain)")


ASCII_CASES = [
    "What is the rent for the first year?",
    "Invoice INV-2022/23-0042 dated 30-Jul-22 for Rs. 42,800.00 (incl. GST @18%)",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "numbers 1234567890 3.14159 1,000,000.00 $1.2M",
    "punctuation!!! (parentheses) {braces} a-b-c e.g., etc.;",
    "UPPER lower MiXeD\t\ttabs\nnewlines   spaces",
    "x" * 150,  # long-word -> UNK
    "a",
    "del\x7fchar splits\x7f like control",  # DEL is Cc: stripped, not kept in-word
    "bell\x07 and\x1f unit separators",
]


@pytest.fixture(scope="module")
def py_tok():
    return WordPieceTokenizer(use_native=False)


@pytest.fixture(scope="module")
def nat():
    return native.NativeWordPiece(inverse_vocab(load_vocab()))


class TestNativeWordPiece:
    @pytest.mark.parametrize("text", ASCII_CASES)
    def test_parity_with_python(self, py_tok, nat, text):
        expected = py_tok.convert_tokens_to_ids(py_tok.tokenize(text))
        assert nat.tokenize_ids(text) == expected

    def test_batch_matches_single(self, nat):
        outs = nat.tokenize_ids_batch(ASCII_CASES, max_out=510)
        for text, ids in zip(ASCII_CASES, outs):
            assert ids == nat.tokenize_ids(text)[:510]

    def test_tokenizer_integration_routes_native(self):
        tok = WordPieceTokenizer(use_native=True)
        ref = WordPieceTokenizer(use_native=False)
        for text in ASCII_CASES:
            assert tok.encode(text) == ref.encode(text)
        # non-ASCII routes through Python and still matches
        uni = "café 北京 naïve résumé"
        assert tok.encode(uni) == ref.encode(uni)
        assert tok._native is not None  # fast path actually engaged

    def test_throughput_sane(self, nat):
        texts = ["The rent for year two is Rs 42,800 per month including GST. " * 20] * 200
        t0 = time.perf_counter()
        nat.tokenize_ids_batch(texts, max_out=510)
        assert time.perf_counter() - t0 < 2.0  # ~50k+ tokens well under 2s


class TestNativeBM25:
    CORPUS = [
        "the rent amount is forty thousand rupees",
        "gst tax at eighteen percent applies to the invoice",
        "lock in period of thirty six months",
        "the weather is mild in paris in spring",
        "rent rent rent repeated term document",
    ]

    def test_parity_with_python(self):
        nb = native.NativeBM25(self.CORPUS)
        pb = BM25([t.split() for t in self.CORPUS])
        for q in ["rent amount", "gst invoice", "the", "missing words entirely", "rent"]:
            np.testing.assert_allclose(nb.get_scores(q), pb.get_scores(q.split()),
                                       rtol=1e-5, atol=1e-6)

    def test_empty_query(self):
        nb = native.NativeBM25(self.CORPUS)
        assert nb.get_scores("").sum() == 0.0


# ------------------------------------------------- against the JAX package

def _seeded_texts(seed: int, n: int):
    """ASCII sentences from the vocabulary's own words, plus texts that must
    take the Python path: non-ASCII, and special-token literals."""
    rng = np.random.default_rng(seed)
    words = [w for w in inverse_vocab(load_vocab()) if w.isascii() and w.isalpha()
             and not w.startswith("[")]
    texts = []
    for _ in range(n):
        toks = [words[i] for i in rng.integers(0, len(words), int(rng.integers(3, 40)))]
        toks[int(rng.integers(0, len(toks)))] = f"Rs {int(rng.integers(10, 10**7)):,}.00"
        texts.append(" ".join(toks))
    python_path = ["café au lait costs € 4,20", "北京 office lease 2022", "naïve résumé",
                   "[CLS] rent [SEP] year two", "the [MASK] amount is due",
                   "mixed [UNK] and ünïcödé"]
    return texts, python_path


def test_wordpiece_ids_match_the_jax_package():
    texts, python_path = _seeded_texts(0, 64)
    ours, theirs = WordPieceTokenizer(), JaxWordPieceTokenizer()
    for text in texts + python_path:
        assert ours.token_ids(text) == theirs.token_ids(text), text
        assert ours.encode(text) == theirs.encode(text), text
    assert ours._native is not None and theirs._native is not None
    assert all(ours._native_safe(t) for t in texts)
    assert not any(ours._native_safe(t) or theirs._native_safe(t) for t in python_path)
    ids, lens = ours.encode_many_packed(texts + python_path, max_len=128)
    jids, jlens = theirs.encode_many_packed(texts + python_path, max_len=128)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lens, jlens)


def test_bm25_scores_match_the_jax_native_and_numpy_scorers():
    texts, _ = _seeded_texts(1, 200)
    corpus = [t.lower() for t in texts]
    scorer = tbm25.build_scorer(corpus)
    assert isinstance(scorer, tbm25._NativeScorer)
    jax_scorer = jnative.NativeBM25(corpus)
    numpy_scorer = tbm25._PyScorer(corpus)
    rng = np.random.default_rng(2)
    for q in [" ".join(corpus[i].split()[:4]) for i in rng.integers(0, 200, 12)] + ["", "zzz"]:
        got = scorer.score_text(q)
        np.testing.assert_allclose(got, jax_scorer.get_scores(q), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, numpy_scorer.score_text(q), rtol=0, atol=1e-6)


def test_chunker_word_starts_match_the_jax_package():
    texts, python_path = _seeded_texts(3, 32)
    ours, theirs = tchunker._native(), jchunker._native()
    assert ours is not None and theirs is not None
    for text in texts:
        raw = text.encode("ascii")
        want = [m.start() for m in re.finditer(r"\w+", text)]
        assert ours[0](raw) == theirs[0](raw) == len(want)
        np.testing.assert_array_equal(ours[1](raw), theirs[1](raw))
        np.testing.assert_array_equal(ours[1](raw), want)


def test_library_is_built_from_the_port_sources_into_build_native():
    lib = native.lib_path()
    assert lib == ROOT / "build" / "native" / "libfragnative.so"
    assert native._lib._name == str(lib)
    assert "financial_rag_tpu/native" not in native._lib._name
    src = ROOT / "financial_rag_tpu_torch" / "native"
    for name in native.SOURCES:
        assert (src / name).read_bytes() == (ROOT / "financial_rag_tpu" / "native" /
                                             name).read_bytes(), f"{name} differs from the JAX copy"
        assert lib.stat().st_mtime >= (src / name).stat().st_mtime
    assert sorted(p.name for p in src.glob("*.cc")) == sorted(native.SOURCES)


def test_first_use_builds_the_library(tmp_path):
    """A fresh process with an empty build directory compiles the sources
    there at first use and reports the compiler, the time and the path."""
    code = ("import json; from financial_rag_tpu_torch import native;"
            "ok = native.available(); print(json.dumps([ok, native.BUILD_INFO]))")
    env = dict(os.environ, FRAG_NATIVE_BUILD_DIR=str(tmp_path / "nb"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json
    ok, info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ok and info["library"] == str(tmp_path / "nb" / "libfragnative.so")
    assert info["compiler"] and info["seconds"] > 0
    assert (tmp_path / "nb" / "libfragnative.so").exists()
