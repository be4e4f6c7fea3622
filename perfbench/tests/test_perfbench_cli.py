"""The command: without a card it refuses and prints no result; on a card
(marked ``cuda``) one short run prints the result line."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CMD = [sys.executable, "perfbench/run.py", "--workload", "heat2d-easy-f64",
       "--seed", "3000000017", "--seconds", "1"]


def _run(*extra):
    return subprocess.run(CMD + list(extra), cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, BENCH_RUN="test"))


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run("--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


@pytest.mark.cuda
def test_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run("--trace", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "check"
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert {"kernels_per_step", "device_idle_pct"} <= set(result["metrics"])
