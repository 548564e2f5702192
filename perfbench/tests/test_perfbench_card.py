"""One short run of a cell through the benchmark's command, on the
card; skips where there is none (the check is made inside the fixture)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: perfbench runs its cells on the card")


def test_a_short_run_is_correct_and_complete(card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "nf64.sample.b32.bf16", "--seed", "2147483999", "--seconds", "3",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"sample_slices_per_s", "peak_mem_gib", "setup_s"}
    assert list(line)[-1] == "checks"
