"""The port stands alone: no import of JAX or of the JAX package, and none
of werkzeug or flask (its HTTP app runs on the standard library, where
werkzeug is not installed)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "financial_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return (top == "jax" or top.startswith("jax") or top == "financial_rag_tpu"
            or top in ("werkzeug", "flask"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    """No import of jax*, financial_rag_tpu, werkzeug or flask."""
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_runtime_import_leaves_jax_unloaded():
    code = ("import sys, financial_rag_tpu_torch.runtime, financial_rag_tpu_torch.ops.kernel_lib;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'financial_rag_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_files_include_the_server():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"financial_rag_tpu_torch/__main__.py", "financial_rag_tpu_torch/serving/app.py",
            "financial_rag_tpu_torch/serving/processor.py",
            "financial_rag_tpu_torch/serving/formatting.py"} <= names


def test_server_import_leaves_werkzeug_and_jax_unloaded():
    code = ("import sys, financial_rag_tpu_torch.__main__, financial_rag_tpu_torch.serving.app;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'financial_rag_tpu', 'werkzeug', 'flask')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


OPERATOR_SCRIPTS = ("ingest_all", "check_collections", "test_full_flow", "pc_retrieval_smoke",
                    "pc_llm_answer", "run_end_to_end", "serve", "recall_eval")


def test_port_files_include_the_operator_scripts():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"financial_rag_tpu_torch/scripts/{n}.py" for n in OPERATOR_SCRIPTS} <= names


def test_operator_scripts_import_leaves_jax_unloaded():
    code = ("import importlib, sys\n"
            f"for n in {OPERATOR_SCRIPTS!r}:\n"
            "    importlib.import_module(f'financial_rag_tpu_torch.scripts.{n}')\n"
            "importlib.import_module('financial_rag_tpu_torch.tokenizer.hf_json')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'financial_rag_tpu', 'tokenizers', 'regex')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
