#!/usr/bin/env python
"""Write the BPE tokenizer fixtures that the port's tokenizer.json reader is
held to: three small tokenizers of the families that Qwen2, Llama-3 and
Llama-2 / Mistral checkpoints ship, trained with the ``tokenizers`` package
on the repository's own text (the golden corpus and questions, the prompt
templates, the filler words) and some text that is not ASCII.

    python tests/data/bpe/make_fixtures.py

Each family's directory gets ``tokenizer.json``, ``tokenizer_config.json``
(its chat template) and ``probes.json``: strings with the ids, tokens and
decoded text that ``tokenizers`` gives for them. The tests and
``chip_smoke.py`` read these files; nothing runs this script but a person
who wants to change them (the output is deterministic).
"""

import importlib.util
import json
import sys
from collections import Counter
from pathlib import Path

from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
          "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")
LLAMA3_TEMPLATE = ("{{ bos_token }}{% for message in messages %}{{ '<|start_header_id|>' + "
                   "message['role'] + '<|end_header_id|>\\n\\n' + message['content'] | trim + "
                   "'<|eot_id|>' }}{% endfor %}")
INST = ("{{ bos_token }}{% for message in messages %}{% if message['role'] == 'user' %}"
        "{{ '[INST] ' + message['content'] + ' [/INST]' }}{% else %}"
        "{{ message['content'] + eos_token }}{% endif %}{% endfor %}")

NON_ASCII = [
    "café naïve résumé façade coöperate Zürich São Paulo",
    "₹ 42,800 — “quoted” ‘single’ … • ½ ¾ °C",
    "日本語のテキスト 東京 北京 价格 金额 合同",
    "Привет мир, арендная плата",
    "किराया राशि ₹ ४२,८०० रुपये",
    "emoji 🙂 📈 💰 ✅",
]

PROBES = [
    "What is the rent for the second year?",
    "<|im_start|>user\nWhat is the lock-in period of the lease?<|im_end|>\n"
    "<|im_start|>assistant\n",
    "[INST] What is the rent? 日本 [/INST]",
    "Rs 2,54,434 rounded; CGST at 9 percent: Rs 19,406.25.",
    "I'll say we've DON'T it's THEY'RE you'd",
    "digits 1234567890 and 3.14159 and 12,480 units",
    "café naïve é ñ Å",
    "line one\r\nline two\n\n\ttabbed   spaced  ",
    "separators \x1c\x1d\x1e\x1f between",
    "日本語 テキスト 价格 🙂📈 ₹ — “quotes”",
    "  leading spaces and trailing  ",
    "<|im_end|><|im_end|>double",
    "",
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus():
    """Lines of the repository's text: the golden corpus and questions,
    the prompt templates, the filler words, PAPER.md and SURVEY.md, and the
    non-ASCII lines."""
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from financial_rag_tpu_torch.llm.prompts import QUERY_NORMALIZE, build_answer_prompt

    lines = [*cs.GOLDEN_CORPUS.values(), *cs.GOLDEN_QUESTIONS, " ".join(cs.FILLER_WORDS),
             QUERY_NORMALIZE.format(question=cs.GOLDEN_QUESTIONS[0]),
             build_answer_prompt(cs.GOLDEN_QUESTIONS[1],
                                 [{"content": cs.GOLDEN_CORPUS["lease_2022"],
                                   "document_id": "lease_2022", "page_start": 1,
                                   "page_end": 2}], ["rent second year"]),
             *NON_ASCII,
             *[(ROOT / name).read_text(encoding="utf-8") for name in ("PAPER.md", "SURVEY.md")]]
    return [ln for text in lines for ln in text.splitlines() if ln.strip()] * 3


def added(tokens, ids):
    return [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for t, i in zip(tokens, ids)]


def byte_level(pattern, specials, vocab_size):
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(specials), show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return json.loads(tok.to_str())


def qwen2_style():
    specials = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
    spec = byte_level(QWEN2_PATTERN, specials, 3000)
    spec["post_processor"] = {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": False, "use_regex": False}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": False,
                       "trim_offsets": False, "use_regex": False}
    return spec, {"chat_template": CHATML, "eos_token": "<|im_end|>",
                  "pad_token": "<|endoftext|>", "bos_token": None}


def llama3_style():
    specials = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>")
    spec = byte_level(LLAMA3_PATTERN, specials, 3000)
    spec["normalizer"] = None
    spec["model"]["ignore_merges"] = True
    bos = spec["model"]["vocab"]["<|begin_of_text|>"]
    spec["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
         "use_regex": True},
        {"type": "TemplateProcessing",
         "single": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}}],
         "pair": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 1}},
                  {"Sequence": {"id": "B", "type_id": 1}}],
         "special_tokens": {"<|begin_of_text|>": {"id": "<|begin_of_text|>", "ids": [bos],
                                                  "tokens": ["<|begin_of_text|>"]}}}]}
    return spec, {"chat_template": LLAMA3_TEMPLATE, "bos_token": "<|begin_of_text|>",
                  "eos_token": "<|eot_id|>"}


def llama2_style():
    """Trained behind a Metaspace pre-tokenizer, so no merge spans a word
    boundary; then written as the Llama-2 file is: no pre-tokenizer, the
    Prepend + Replace normalizer, byte fallback to <0x00>-<0xFF> at ids
    3-258 (ordinary vocabulary, not added tokens)."""
    lines = corpus()
    counts = Counter(c for ln in lines for c in ln.replace(" ", "▁"))
    # the 120 commonest characters, ties by code point (tokenizers' own
    # limit_alphabet breaks ties in hash order); the rest falls back to bytes
    alphabet = sorted(counts, key=lambda c: (-counts[c], c))[:120]
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.train_from_iterator(lines, trainers.BpeTrainer(
        vocab_size=2800, special_tokens=["<unk>", "<s>", "</s>"], initial_alphabet=alphabet,
        limit_alphabet=len(alphabet), show_progress=False))
    trained = json.loads(tok.to_str())["model"]
    order = ["<unk>", "<s>", "</s>", *[f"<0x{b:02X}>" for b in range(256)],
             *[t for t, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1])
               if t not in ("<unk>", "<s>", "</s>")]]
    vocab = {t: i for i, t in enumerate(order)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added(["<unk>", "<s>", "</s>"], [0, 1, 2]),
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": trained["merges"]},
    }
    return spec, {"chat_template": INST, "bos_token": "<s>", "eos_token": "</s>",
                  "unk_token": "<unk>"}


def probes(tok: Tokenizer):
    out = []
    for text in PROBES:
        enc = tok.encode(text)
        out.append({"text": text, "ids": enc.ids, "tokens": enc.tokens,
                    "decoded": tok.decode(enc.ids, skip_special_tokens=True),
                    "decoded_with_special": tok.decode(enc.ids, skip_special_tokens=False)})
    return out


def main() -> None:
    for name, make in (("qwen2_style", qwen2_style), ("llama3_style", llama3_style),
                       ("llama2_style", llama2_style)):
        spec, config = make()
        text = json.dumps(spec, ensure_ascii=False, separators=(",", ":"))
        tok = Tokenizer.from_str(text)         # the file must load in tokenizers
        d = HERE / name
        d.mkdir(exist_ok=True)
        (d / "tokenizer.json").write_text(text, encoding="utf-8")
        (d / "tokenizer_config.json").write_text(json.dumps(config, indent=1) + "\n")
        (d / "probes.json").write_text(json.dumps(probes(tok), ensure_ascii=False, indent=1)
                                       + "\n", encoding="utf-8")
        print(f"{name}: {tok.get_vocab_size()} ids, {len(spec['model']['merges'])} merges, "
              f"{len(text)} bytes")


if __name__ == "__main__":
    main()
