"""Every file the harness finds by name loads, and the manifest keeps to
its contract: names and units of the allowed characters, each cell's
files present, each metric's reader present, the bounds in range."""

import importlib
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    path = ROOT / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def test_manifest_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for w in cmd:
        if "/" in w and (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert 2 + 14 * 24 * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(manifest):
    from perfbench.reference import model

    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["name"] in used and c["file"] not in files
        files.add(c["file"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert cfg["reduced"] == c["reduced"]
        model.check_config(cfg)


def test_workloads_and_their_files(manifest):
    names = [w["name"] for w in manifest["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in manifest["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        with open(ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
            tr = json.load(f)
        importlib.import_module(f"perfbench.drivers.{tr['driver']}")
        with open(ROOT / "perfbench" / "workloads" / f"{w['name']}.json") as f:
            lim = json.load(f)
        assert lim["limits"] and all(NAME.match(k) and v >= 0 for k, v in lim["limits"].items())


def _reports(manifest, cell):
    e2e = {m["name"] for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])}
    per = {m["name"] for m in manifest["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])}
    return e2e, per


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    seen = set()
    e2e_names = set()
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        e2e_names.add(m["name"])
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names and TEXT.match(m["layer"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", []):
            assert cell in cells and m["moves"] in _reports(manifest, cell)[0]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
    for cell in cells:
        e2e, per = _reports(manifest, cell)
        assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_kernel_families_and_traffic_files_load():
    for p in (ROOT / "perfbench" / "kernels").glob("*.json"):
        with open(p) as f:
            fam = json.load(f)
        assert NAME.match(p.stem) and [re.compile(x) for x in fam["patterns"]]
    for p in (ROOT / "perfbench" / "traffic").glob("*.json"):
        with open(p) as f:
            assert "driver" in json.load(f)
