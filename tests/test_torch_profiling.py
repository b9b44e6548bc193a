"""utils/profiling.profile_trace: a torch.profiler capture around a block
writes a Chrome trace into its directory, and utils/timing's blocks appear
in it by label (the port's counterpart of the JAX package's
jax.profiler trace, whose TraceMe annotations carry the same labels)."""

import json

import torch

from financial_rag_tpu_torch.utils import time_block
from financial_rag_tpu_torch.utils.profiling import profile_trace


def test_profile_trace_writes_a_chrome_trace_with_the_time_block_labels(tmp_path):
    out_dir = tmp_path / "profiles"
    with profile_trace(out_dir) as out:
        assert out == out_dir and out.is_dir()
        with time_block("hybrid.search"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with time_block("encoder.forward_s64"):
            torch.relu(torch.ones(8))
    traces = list(out_dir.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"hybrid.search", "encoder.forward_s64"} <= names


def test_profile_trace_writes_its_trace_when_the_block_raises(tmp_path):
    try:
        with profile_trace(tmp_path):
            with time_block("engine.rerank"):
                raise ValueError("inside the capture")
    except ValueError:
        pass
    (trace,) = tmp_path.glob("trace_*.json")
    assert "engine.rerank" in trace.read_text()
