"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick (the reference, the inputs, the arithmetic) loads nothing of
the program.  Each check runs in a fresh interpreter and compares the
top-level name of every loaded module, whole."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mudiff_tpu", "bench"}

_LOAD = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, {root!r})
mods = {mods!r}
for name in mods:
    importlib.import_module(name)
if {readers!r}:
    from pathlib import Path
    for p in sorted(Path({root!r}, "perfbench", "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _tops(mods, readers=False):
    code = _LOAD.format(root=str(ROOT), mods=list(mods), readers=readers)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), env={"PATH": "/usr/bin:/bin",
                                                          "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _perfbench_modules():
    mods = []
    for p in sorted((ROOT / "perfbench").rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts
        if parts[1] in ("metrics", "tests") or "." in parts[-1]:
            continue
        mods.append(".".join(p for p in parts if p != "__init__"))
    return mods


def test_every_perfbench_module_and_the_ports_entry_points_load_no_jax():
    mods = _perfbench_modules() + ["mudiff_torch.sampler", "mudiff_torch.train",
                                   "mudiff_torch.train.steps", "mudiff_torch.infer.calibrate"]
    tops = _tops(mods, readers=True)
    assert "perfbench" in tops and "mudiff_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_yardstick_loads_nothing_of_the_program():
    mods = ["perfbench.reference.model", "perfbench.reference.diffusion",
            "perfbench.reference.ops", "perfbench.inputs.phantom", "perfbench.inputs.weights",
            "perfbench.arith", "perfbench.peaks"]
    tops = _tops(mods)
    assert not tops & (FORBIDDEN | {"mudiff_torch"}), tops
