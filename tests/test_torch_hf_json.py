"""The port's tokenizer.json reader (financial_rag_tpu_torch/tokenizer/hf_json.py)
against the ``tokenizers`` package, on the BPE families the port's decoder
serves.

The fixtures under tests/data/bpe/ are small tokenizers of the Qwen2
(byte-level, NFC, Qwen2's split regex), Llama-3 (byte-level, Llama-3's
regex, ignore_merges, a BOS template) and Llama-2 / Mistral (byte
fallback, Prepend + Replace normalizer, ``<s>`` template) families,
written by tests/data/bpe/make_fixtures.py with ``tokenizers``; each has
the ids, tokens and decoded text ``tokenizers`` gave for its probe
strings. The probe cases need only those files. The rest compare with
``tokenizers`` live, and skip where it is not installed: the probes again
with every decoded prefix, hypothesis text, both stored forms of the
merges, the other pre-tokenizer and decoder forms of each family, and
decoding every prefix of multi-byte sequences.
"""

import json
import re
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer, bytes_to_unicode
from financial_rag_tpu_torch.tokenizer.hf_json import translate_pattern

DATA = Path(__file__).resolve().parent / "data" / "bpe"
FAMILIES = ("qwen2_style", "llama3_style", "llama2_style")


def _spec(family):
    return json.loads((DATA / family / "tokenizer.json").read_text(encoding="utf-8"))


def _probes(family):
    return json.loads((DATA / family / "probes.json").read_text(encoding="utf-8"))


PROBES = [(f, i) for f in FAMILIES for i in range(len(_probes(f)))]


@pytest.fixture(scope="module")
def readers():
    return {f: HFTokenizer(_spec(f)) for f in FAMILIES}


@pytest.fixture(scope="module")
def tk():
    return pytest.importorskip("tokenizers")


# ------------------------------------------------------ the committed probes

@pytest.mark.parametrize("family,i", PROBES, ids=[f"{f}-{i}" for f, i in PROBES])
def test_probe_matches_what_tokenizers_wrote(readers, family, i):
    probe = _probes(family)[i]
    enc = readers[family].encode(probe["text"])
    assert enc.ids == probe["ids"]
    assert enc.tokens == probe["tokens"]
    assert readers[family].decode(enc.ids) == probe["decoded"]
    assert readers[family].decode(enc.ids, skip_special_tokens=False) == \
        probe["decoded_with_special"]


@pytest.mark.parametrize("family", FAMILIES)
def test_fixture_is_the_family_it_names(family):
    spec = _spec(family)
    model = spec["model"]
    assert model["type"] == "BPE" and 2_000 <= len(model["vocab"]) <= 4_000
    assert all(isinstance(m, list) for m in model["merges"])   # the form tokenizers 0.22 writes
    assert (DATA / family / "tokenizer.json").stat().st_size < 300_000
    config = json.loads((DATA / family / "tokenizer_config.json").read_text())
    if family == "llama2_style":
        assert model["byte_fallback"] and "[INST]" in config["chat_template"]
        assert all(f"<0x{b:02X}>" in model["vocab"] for b in range(256))
        # the byte tokens are vocabulary, not special added tokens
        assert {t["content"] for t in spec["added_tokens"]} == {"<unk>", "<s>", "</s>"}
    else:
        assert set(bytes_to_unicode()) <= set(model["vocab"])
        assert model["ignore_merges"] == (family == "llama3_style")
    if family == "qwen2_style":
        assert spec["normalizer"] == {"type": "NFC"} and "im_start" in config["chat_template"]


def test_add_special_tokens_adds_the_template_tokens(readers):
    for family, first in (("llama2_style", "<s>"), ("llama3_style", "<|begin_of_text|>")):
        tok = readers[family]
        with_bos = tok.encode("What is the rent?")
        plain = tok.encode("What is the rent?", add_special_tokens=False)
        assert with_bos.tokens[0] == first and with_bos.ids[1:] == plain.ids
    qwen = readers["qwen2_style"]
    assert qwen.encode("rent").ids == qwen.encode("rent", add_special_tokens=False).ids


# ------------------------------------------------------ against tokenizers

def _same(ref, ours, text, prefixes=True):
    for add in (True, False):
        want = ref.encode(text, add_special_tokens=add)
        got = ours.encode(text, add_special_tokens=add)
        assert got.ids == want.ids, (text, add)
        assert got.tokens == want.tokens, (text, add)
    ids = ref.encode(text).ids
    for k in (range(len(ids) + 1) if prefixes else [len(ids)]):
        for skip in (True, False):
            assert ours.decode(ids[:k], skip_special_tokens=skip) == \
                ref.decode(ids[:k], skip_special_tokens=skip), (text, k, skip)


@pytest.mark.parametrize("family", FAMILIES)
def test_probes_and_every_decoded_prefix_match_tokenizers(tk, readers, family):
    ref = tk.Tokenizer.from_file(str(DATA / family / "tokenizer.json"))
    for probe in _probes(family):
        _same(ref, readers[family], probe["text"])
        assert ref.encode(probe["text"]).ids == probe["ids"]     # the file is current


PIECES = st.sampled_from([
    "\r\n", "\n", "\r", "\n\n", "\x1c", "\x1d", "\x1e", "\x1f", " ", "  ", "\t", "　",
    "\xa0", "'s", "'S", "'ll", "'LL", "'ve", "'re", "'d", "n't", "don't", "I'm",
    "é", "ä", "́", "ño", "0", "7", "12", "123", "1234567", "3.14",
    "42,800", "Rs", "rent", "the", " the", "invoice", "GST", "日本語", "价格", "東京",
    "🙂", "📈", "👍🏽", "₹", "—", "“", "…", "é", "ß", "Ω", "ﬁ", "<|im_end|>",
    "<|im_start|>", "<|endoftext|>", "<|begin_of_text|>", "<|eot_id|>", "<s>", "</s>",
    "<unk>", "[INST]", "[/INST]", "▁", "<0x0A>"])
TEXT = st.lists(st.one_of(PIECES, st.text(st.characters(exclude_categories=("Cs",)),
                                          max_size=4)), max_size=14).map("".join)


@pytest.mark.parametrize("family", FAMILIES)
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_hypothesis_text_matches_tokenizers(tk, readers, family, text):
    ref = tk.Tokenizer.from_file(str(DATA / family / "tokenizer.json"))
    _same(ref, readers[family], text)


def _variants(family):
    """The family's other forms: merges as "a b" strings; for the
    byte-level families ByteLevel(use_regex=true) with GPT-2's pattern; for
    Llama-2 a Metaspace pre-tokenizer in place of the normalizer
    (prepend_scheme first or always, split or not)."""
    out = {}
    spec = _spec(family)
    out["merges_as_strings"] = dict(spec, model=dict(
        spec["model"], merges=[" ".join(m) for m in spec["model"]["merges"]]))
    if family != "llama2_style":
        out["gpt2_regex"] = dict(spec, pre_tokenizer={
            "type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
            "use_regex": True})
    else:
        for scheme in ("first", "always"):
            for split in (True, False):
                out[f"metaspace_{scheme}_split_{split}"] = dict(spec, normalizer=None, pre_tokenizer={
                    "type": "Metaspace", "replacement": "▁", "prepend_scheme": scheme,
                    "split": split})
    return out


VARIANTS = [(f, v) for f in FAMILIES for v in _variants(f)]


@pytest.mark.parametrize("family,variant", VARIANTS, ids=[f"{f}-{v}" for f, v in VARIANTS])
def test_other_forms_of_the_family_match_tokenizers(tk, family, variant):
    spec = _variants(family)[variant]
    ref = tk.Tokenizer.from_str(json.dumps(spec))
    ours = HFTokenizer(spec)
    texts = [p["text"] for p in _probes(family)] + [
        "<|im_start|>user\n  Hello  world<|im_end|>", " leading", "a　b\xa0c",
        "x \x1c y", "日本 🙂  ", "<s> hi </s>"]
    for text in texts:
        _same(ref, ours, text)


def _byte_ids(spec, text):
    """One token per UTF-8 byte of ``text``: the byte-level characters, or
    the <0xXX> fallback tokens."""
    vocab = spec["model"]["vocab"]
    if spec["model"].get("byte_fallback"):
        return [vocab[f"<0x{b:02X}>"] for b in text.encode("utf-8")]
    table = bytes_to_unicode()
    return [vocab[table[b]] for b in text.encode("utf-8")]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("text", ["日本", "🙂📈", "é€", "a👍🏽b", "\xff".encode("latin-1").decode("latin-1")])
def test_every_prefix_of_a_multibyte_sequence_decodes_as_tokenizers(tk, readers, family, text):
    """A stream decodes prefixes of the tokens: a prefix that ends inside a
    character gives the replacement characters tokenizers gives; bytes
    that never form UTF-8 too (the lone 0xC3 0xBF of "ÿ" cut, and 0xFF
    alone)."""
    ref = tk.Tokenizer.from_file(str(DATA / family / "tokenizer.json"))
    spec = _spec(family)
    ids = _byte_ids(spec, text)
    lone = [spec["model"]["vocab"]["<0xFF>" if family == "llama2_style" else bytes_to_unicode()[0xFF]]]
    for seq in (ids, ids[1:], ids + lone + ids, lone):
        for k in range(len(seq) + 1):
            for skip in (True, False):
                assert readers[family].decode(seq[:k], skip_special_tokens=skip) == \
                    ref.decode(seq[:k], skip_special_tokens=skip), (text, seq, k)


# ------------------------------------------------------- the regex

def test_translated_classes_follow_unicode_not_python():
    ws = re.compile(translate_pattern(r"\s+"))
    assert ws.fullmatch(" \t\n\r\x0b\x0c\x85\xa0 　")
    assert not ws.search("\x1c\x1d\x1e\x1f")            # Python's \s has these
    letters = re.compile(translate_pattern(r"\p{L}+"))
    assert letters.fullmatch("éßΩ日本語") and not letters.search("1_ ́")
    assert re.compile(translate_pattern(r"\p{N}")).fullmatch("४")
    other = re.compile(translate_pattern(r"[^\s\p{L}\p{N}]+"))
    assert other.fullmatch("—“…🙂") and not other.search("a1 ")
    assert re.compile(translate_pattern(r"\S+")).fullmatch("\x1c")
    for bmp in (False, True):
        assert re.compile(translate_pattern(r"\p{Lu}", bmp)).fullmatch("Ω")
    assert re.compile(translate_pattern(r"\p{L}")).fullmatch("\U00020000")   # CJK ext. B


# ----------------------------------------------- what stays unsupported

def _bpe(**model):
    spec = _spec("qwen2_style")
    return dict(spec, model=dict(spec["model"], **model))


UNSUPPORTED = {
    "model_unigram": (lambda: dict(_spec("qwen2_style"), model={"type": "Unigram", "vocab": []}),
                      "Unigram"),
    "model_wordpiece": (lambda: dict(_spec("qwen2_style"), model={"type": "WordPiece"}),
                        "WordPiece"),
    "bpe_dropout": (lambda: _bpe(dropout=0.1), "dropout"),
    "bpe_continuing_subword_prefix": (lambda: _bpe(continuing_subword_prefix="##"),
                                      "continuing_subword_prefix"),
    "bpe_end_of_word_suffix": (lambda: _bpe(end_of_word_suffix="</w>"), "end_of_word_suffix"),
    "normalizer_nfkc": (lambda: dict(_spec("qwen2_style"), normalizer={"type": "NFKC"}), "NFKC"),
    "normalizer_lowercase": (lambda: dict(_spec("qwen2_style"), normalizer={
        "type": "Sequence", "normalizers": [{"type": "NFC"}, {"type": "Lowercase"}]}), "Lowercase"),
    "normalizer_replace_regex": (lambda: dict(_spec("llama2_style"), normalizer={
        "type": "Replace", "pattern": {"Regex": " +"}, "content": "▁"}), "Regex"),
    "pre_tokenizer_bert": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "BertPreTokenizer"}), "BertPreTokenizer"),
    "pre_tokenizer_digits": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "Sequence", "pretokenizers": [{"type": "Digits", "individual_digits": True}]}),
        "Digits"),
    "split_string_pattern": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "Split", "pattern": {"String": " "}, "behavior": "Isolated", "invert": False}),
        "String"),
    "byte_level_prefix_space": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True}),
        "add_prefix_space"),
    "decoder_metaspace": (lambda: dict(_spec("llama2_style"), decoder={
        "type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False}),
        "Metaspace"),
    "split_removed": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "Split", "pattern": {"String": " "}, "behavior": "Removed", "invert": False}),
        "Removed"),
    "split_invert": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "Split", "pattern": {"String": " "}, "behavior": "Isolated", "invert": True}),
        "invert"),
    "regex_script_class": (lambda: dict(_spec("qwen2_style"), pre_tokenizer={
        "type": "Split", "pattern": {"Regex": r"\p{Han}+"}, "behavior": "Isolated",
        "invert": False}), "Han"),
    "metaspace_scheme": (lambda: dict(_spec("llama2_style"), pre_tokenizer={
        "type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": True}),
        "never"),
    "decoder_wordpiece": (lambda: dict(_spec("qwen2_style"), decoder={"type": "WordPiece"}),
                          "WordPiece"),
    "decoder_bpe": (lambda: dict(_spec("qwen2_style"), decoder={"type": "BPEDecoder"}),
                    "BPEDecoder"),
    "decoder_replace_regex": (lambda: dict(_spec("llama2_style"), decoder={
        "type": "Replace", "pattern": {"Regex": "▁"}, "content": " "}), "Regex"),
    "post_processor_roberta": (lambda: dict(_spec("qwen2_style"), post_processor={
        "type": "RobertaProcessing"}), "RobertaProcessing"),
    "post_processor_bert": (lambda: dict(_spec("qwen2_style"), post_processor={
        "type": "BertProcessing"}), "BertProcessing"),
    "template_of_a_pair": (lambda: dict(_spec("llama2_style"), post_processor=dict(
        _spec("llama2_style")["post_processor"], single=[{"Sequence": {"id": "B", "type_id": 0}}])),
        "TemplateProcessing"),
    "truncation": (lambda: dict(_spec("qwen2_style"), truncation={"max_length": 8}),
                   "truncation"),
    "added_token_lstrip": (lambda: dict(_spec("qwen2_style"), added_tokens=[
        dict(_spec("qwen2_style")["added_tokens"][0], lstrip=True)]), "lstrip"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_what_is_not_read_raises_naming_it(case):
    make, needle = UNSUPPORTED[case]
    with pytest.raises(NotImplementedError, match=re.escape(needle)):
        HFTokenizer(make())
