"""mudiff_torch stands alone: no JAX, no flax, nothing of mudiff_tpu.

The port runs on a machine without JAX, so a stray import would break
it there while every parity test (which imports both packages) passes
here.  The check runs in a fresh interpreter.  ``chip_smoke.py`` must
refuse to report success without a CUDA device, and must fail in a
directory that holds it and nothing else of the repo; its ``kernels``
line must carry every key, summed over the launches it counts, and name
the TPU kernel each CUDA kernel replaces.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mudiff_torch
names = [m.name for m in pkgutil.walk_packages(mudiff_torch.__path__, "mudiff_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mudiff_tpu"))
print(len(names), bad)
assert len(names) >= 15, names
assert not bad, bad
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_imports_no_jax_or_mudiff_tpu():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", ["mudiff_torch", "chip_smoke.py"])
def test_sources_name_no_jax_import(path):
    files = [REPO / path] if path.endswith(".py") else sorted((REPO / path).rglob("*.py"))
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0].rstrip(",")
                assert root not in ("jax", "jaxlib", "flax", "mudiff_tpu"), f"{f}: {line}"


def test_chip_smoke_kernels_line_has_every_key():
    """The ``kernels`` entry sums each per-launch number over the
    launches of the main path's run, and refuses counts that disagree."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rows = [
        {"kernel": "fir_up2", "launches": 3, "err_bf16": 0.0, "ms": 0.2, "plain_ms": 1.0,
         "library_ms": 0.5, "flop_ms": 0.001, "byte_ms": 0.02},
        {"kernel": "fir_up2", "launches": 1, "err_bf16": 0.01, "ms": 0.1, "plain_ms": 0.5,
         "library_ms": 0.3, "flop_ms": 0.03, "byte_ms": 0.01},
    ]
    entry = chip_smoke.kernel_summary("fir_up2", rows, 4)
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
    assert entry["route"] == "cuda" and (REPO / entry["source"]).is_file()
    assert entry["launches"] == 4 and entry["max_abs_err"] == 0.01
    assert abs(entry["ms"] - 0.7) < 1e-12 and abs(entry["library_ms"] - 1.8) < 1e-12
    assert abs(entry["bound_ms"] - (3 * 0.02 + 0.03)) < 1e-12
    assert entry["bound_by"] == "bytes"
    with pytest.raises(AssertionError, match="add up"):
        chip_smoke.kernel_summary("fir_up2", rows, 5)


@pytest.mark.parametrize("kernel,function", [
    ("conv3x3", "def conv3x3_gemm("),
    ("fir_down2", "def downsample_2d_pallas("),
    ("fir_up2", "def upsample_2d_pallas("),
])
def test_chip_smoke_names_the_tpu_kernel_each_kernel_replaces(kernel, function):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    source, replaces = chip_smoke.SOURCES[kernel]
    assert (REPO / source).is_file()
    path, line = replaces.split(":")
    assert (REPO / path).read_text().splitlines()[int(line) - 1].startswith(function)


def _smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    proc = _smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone, without the program beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    proc = _smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
