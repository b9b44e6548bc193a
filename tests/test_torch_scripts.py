"""The port's operator scripts (financial_rag_tpu_torch/scripts/) on the CPU.

Each takes the flags and defaults of its root ``scripts/`` counterpart and
prints the lines operators read (tests/test_scripts.py checks the root
ones). The chain runs in process through each script's ``main(argv)``,
under ``FRAG_PLATFORM=cpu``, in one temporary data dir: every script but
the first reloads the indexes that ingest_all saved, and one runs again
in a fresh process through ``python -m``. recall_eval's value is held to
the root script's on the same arguments in the same process (the lexical
encoders' salts are per process).
"""

import argparse
import ast
import importlib
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("ingest_all", "check_collections", "test_full_flow", "pc_retrieval_smoke",
           "pc_llm_answer", "run_end_to_end", "serve", "recall_eval")
LEASE = {"blocks": [{"content": "The rent for the second year is Rs 42,800 per month. "
                                "The lock-in period is 36 months. " * 6, "page": 0}]}


@pytest.fixture
def cpu_env(monkeypatch, tmp_path):
    """FRAG_PLATFORM=cpu, no checkpoints (the lexical encoders), the
    HTTP/Null LLM, and the working directory a fresh temp dir."""
    monkeypatch.setenv("FRAG_PLATFORM", "cpu")
    for var in ("EMBED_BAAI_PATH", "EMBED_GTE_PATH", "CROSS_ENCODER_PATH", "LLM_PROVIDER",
                "LLM_CHECKPOINT", "GEMINI_API_KEY", "INDEX_KIND", "INDEX_DTYPE",
                "INDEX_SHARDS", "ENCODE_DP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _main(name, argv, capsys):
    mod = importlib.import_module(f"financial_rag_tpu_torch.scripts.{name}")
    capsys.readouterr()
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def test_ingest_check_fullflow_chain(cpu_env, capsys):
    docs = cpu_env / "New folder"
    docs.mkdir()
    (docs / "lease.json").write_text(json.dumps(LEASE))

    out = _main("ingest_all", ["--dir", "New folder", "--data-dir", "."], capsys)
    assert "ingested 1 documents (0 failed)" in out
    assert "parents.db: 1 parents" in out
    assert out.count(": 1 vectors") == 2

    out = _main("check_collections", ["--data-dir", "."], capsys)
    assert "parents.db: 1 parents" in out and "children_meta.db: 1 children" in out
    assert "(capacity 1024, backend xla)" in out

    out = _main("test_full_flow", ["--data-dir", ".", "--questions",
                                   "What is the rent for the second year?"], capsys)
    assert "42,800" in out
    logs = list((cpu_env / "test_logs").glob("fullflow_*.json"))
    assert [p.name for p in logs] == ["fullflow_what_is_the_rent_for_the_second_year.json"]
    payload = json.loads(logs[0].read_text())
    assert payload["token_accounting"]["prompt_tokens"] > 0
    assert set(payload) == {"question", "answer", "elapsed_s", "queries", "top_children",
                            "parents", "token_accounting"}

    out = _main("pc_retrieval_smoke", ["--data-dir", ".", "--queries", "rent second year"],
                capsys)
    assert "collections: {'baai': 1, 'gte': 1}" in out
    assert "parent" in out and "doc=lease pages 0-0" in out

    # a fresh process reloads what this one saved
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-m", "financial_rag_tpu_torch.scripts.check_collections",
                           "--data-dir", "."], cwd=cpu_env, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "parents.db: 1 parents" in proc.stdout and "children_meta.db: 1 children" in proc.stdout


def test_empty_indexes_say_so(cpu_env, capsys):
    out = _main("pc_retrieval_smoke", ["--data-dir", "."], capsys)
    assert "indexes are empty" in out


def test_pc_llm_answer_with_the_local_llm_on_a_bpe_checkpoint(cpu_env, capsys, monkeypatch):
    """LLM_PROVIDER=local on a 2-layer checkpoint whose tokenizer.json is
    the committed byte-level BPE fixture: every answer is the model's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hf = {**cs.QWEN2_05B, "vocab_size": 3200, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
          "tie_word_embeddings": False}
    ckpt = cpu_env / "llm"
    cs.write_llm_checkpoint(ckpt, hf, seed=3, device="cpu", bpe_fixture=cs.BPE_FIXTURE)
    monkeypatch.setenv("LLM_PROVIDER", "local")
    monkeypatch.setenv("LLM_CHECKPOINT", str(ckpt))
    monkeypatch.setenv("LLM_DTYPE", "float32")
    monkeypatch.setenv("LLM_MAX_NEW_TOKENS", "16")
    docs = cpu_env / "New folder"
    docs.mkdir()
    (docs / "lease.json").write_text(json.dumps(LEASE))
    (docs / "memo.json").write_text(json.dumps({"blocks": [{"content": "A memo. " * 40,
                                                            "page": 0}]}))

    out = _main("pc_llm_answer", ["--dir", "New folder", "--data-dir", "."], capsys)
    assert "ingesting most invoice-like JSON: New folder/lease.json" in out
    assert out.count("Q: ") == 5 and "LLM unavailable" not in out
    payloads = [json.loads(p.read_text()) for p in (cpu_env / "chunk_logs").glob("qa_llm_payload_*.json")]
    assert len(payloads) == 5
    for p in payloads:
        assert set(p) == {"question", "answer", "child_hits", "parents"}
        assert p["answer"] and not p["answer"].startswith("LLM unavailable")


def test_run_end_to_end(cpu_env, capsys):
    src = cpu_env / "input"
    src.mkdir()
    (src / "doc.json").write_text(json.dumps({"blocks": [
        {"content": "The total invoice amount is Rs 1,18,000 including GST. " * 8, "page": 0}]}))
    out = _main("run_end_to_end", ["--input", "input", "--data-dir", ".",
                                   "--smoke-query", "total invoice amount"], capsys)
    assert "[1/3] extraction" in out and "[2/3] ingesting 1 documents" in out
    assert "doc: 1 parents, 1 children" in out
    assert "retrieval smoke" in out and "child " in out and "parent " in out


def test_serve_builds_the_app_and_hands_it_to_the_server(cpu_env, capsys, monkeypatch):
    from financial_rag_tpu_torch.serving import app as app_mod

    served = {}

    def fake_run_server(app, host, port):
        served.update(app=app, host=host, port=port)
        app.close()
    monkeypatch.setattr(app_mod, "run_server", fake_run_server)
    out = _main("serve", ["--data-dir", ".", "--port", "5999"], capsys)
    assert "serving on http://0.0.0.0:5999 (indexes: {'baai': 0, 'gte': 0})" in out
    assert served["port"] == 5999 and served["host"] == "0.0.0.0"


def test_recall_eval_matches_the_root_script(cpu_env, capsys, monkeypatch):
    out = _main("recall_eval", ["--n-synth", "200", "--out", str(cpu_env / "port.json")], capsys)
    port = json.loads(out.strip().splitlines()[-1])
    assert json.loads((cpu_env / "port.json").read_text()) == port

    monkeypatch.delenv("FRAG_PLATFORM")     # the root script sets jax_platforms from it
    monkeypatch.setattr(sys, "argv", ["recall_eval.py", "--n-synth", "200",
                                      "--out", str(cpu_env / "jax.json")])
    runpy.run_path(str(ROOT / "scripts" / "recall_eval.py"), run_name="__main__")
    ref = json.loads((cpu_env / "jax.json").read_text())
    assert set(port) == set(ref)
    assert abs(port["value"] - ref["value"]) <= 1e-6
    assert port["per_query"] == ref["per_query"]
    assert port["backend"] == ref["backend"] == "cpu"
    assert {k: v for k, v in port.items() if k != "backend"} == \
        {k: v for k, v in ref.items() if k != "backend"}


# ------------------------------------------------------ flags and defaults

def _root_options(name):
    """(option strings) -> (default, type, nargs, required, action) of each
    ``add_argument`` in the root script's source (not imported)."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id.isupper()
              and not isinstance(node.value, (ast.Call, ast.ListComp))}
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            action = ast.literal_eval(kw["action"]) if "action" in kw else "store"
            default = kw.get("default")
            if isinstance(default, ast.Name):
                default = consts[default.id]
            elif default is not None:
                default = ast.literal_eval(default)
            elif action == "store_true":
                default = False
            out[tuple(ast.literal_eval(a) for a in node.args)] = (
                default, kw["type"].id if "type" in kw else None,
                ast.literal_eval(kw["nargs"]) if "nargs" in kw else
                (0 if action == "store_true" else None),
                ast.literal_eval(kw["required"]) if "required" in kw else False, action)
    return out


class _Parsed(Exception):
    pass


def _port_options(name, monkeypatch):
    """The same of the port script's parser, as main() builds it."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    mod = importlib.import_module(f"financial_rag_tpu_torch.scripts.{name}")
    with pytest.raises(_Parsed) as caught:
        mod.main([])
    actions = {argparse._StoreAction: "store", argparse._StoreTrueAction: "store_true"}
    return {tuple(a.option_strings): (a.default, a.type.__name__ if a.type else None, a.nargs,
                                      a.required, actions[type(a)])
            for a in caught.value.args[0]._actions if a.dest != "help"}


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_and_defaults_are_the_root_scripts(name, monkeypatch):
    want = _root_options(name)
    assert want, name
    assert _port_options(name, monkeypatch) == want


def test_every_script_runs_as_a_module():
    """``python -m financial_rag_tpu_torch.scripts.<name> --help`` for all
    eight, in one fresh process (runpy runs each as __main__)."""
    code = ("import runpy, sys\n"
            f"for name in {SCRIPTS!r}:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module(f'financial_rag_tpu_torch.scripts.{name}', run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "    print('ran', name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'financial_rag_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert [ln for ln in proc.stdout.splitlines() if ln.startswith("ran ")] == \
        [f"ran {n}" for n in SCRIPTS]
