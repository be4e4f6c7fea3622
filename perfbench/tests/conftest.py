"""Shared set-up of the benchmark's own tests: a copy of the benchmark with
every grid cut to a few cells, so a whole run takes seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = {2: 32, 3: 12}
TINY_EPISODE = 20


def make_tiny(dest):
    """A copy of the benchmark under ``dest`` with tiny grids and episodes;
    returns ``dest``."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (dest / "perfbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["cells"] = TINY_CELLS[config["ndim"]]
        path.write_text(json.dumps(config))
    for path in (dest / "perfbench" / "workloads").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["episode_steps"] = TINY_EPISODE
        traffic["trace_episodes"] = 1
        path.write_text(json.dumps(traffic))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
