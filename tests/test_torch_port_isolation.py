"""mudiff_torch stands alone: no JAX, no flax, nothing of mudiff_tpu or
``tools/``, and none of the packages the card's machine lacks (PIL, matplotlib,
orbax, optax, yaml): the YAML runner reads its files with
``utils/yaml_lite.py``, the demo writes its PNG with ``utils/png.py``.

The port runs on a machine without them, so a stray import would break
it there while every parity test (which imports both packages) passes
here.  The check runs in a fresh interpreter; matplotlib may be imported
only inside ``utils.reports.plot_evolution``.  ``chip_smoke.py`` must
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

import jax
import pytest

from mudiff_torch import ops

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mudiff_torch
names = [m.name for m in pkgutil.walk_packages(mudiff_torch.__path__, "mudiff_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mudiff_tpu", "tools", "PIL",
                                    "matplotlib", "orbax", "optax", "yaml"))
print(len(names), bad)
assert len(names) >= 15, names
assert {"mudiff_torch.infer.volume", "mudiff_torch.infer.generators",
        "mudiff_torch.cli.args", "mudiff_torch.cli.test_volume",
        "mudiff_torch.utils.nifti", "mudiff_torch.ops.flash_attn",
        "mudiff_torch.models.critic", "mudiff_torch.train.state",
        "mudiff_torch.train.steps", "mudiff_torch.data.datasets",
        "mudiff_torch.data._native", "mudiff_torch.data.loader",
        "mudiff_torch.data.preprocess", "mudiff_torch.utils.png",
        "mudiff_torch.metrics.image_metrics", "mudiff_torch.utils.reports",
        "mudiff_torch.utils.profiling", "mudiff_torch.train.checkpoint",
        "mudiff_torch.train.loop", "mudiff_torch.cli.train", "mudiff_torch.cli.test",
        "mudiff_torch.infer.slice_test", "mudiff_torch.utils.yaml_lite",
        "mudiff_torch.models.registry", "mudiff_torch.nn.remat",
        "mudiff_torch.metrics.lpips", "mudiff_torch.cli.run",
        "mudiff_torch.cli.check_pipeline", "mudiff_torch.cli.calibrate_int8",
        "mudiff_torch.cli.metric_calc", "mudiff_torch.cli.predict_volume_wrapper",
        "mudiff_torch.demo", "mudiff_torch.data.phantom",
        "mudiff_torch.cli.ab_int8_quality"} <= set(names), names
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


@pytest.mark.parametrize("path", ["mudiff_torch", "chip_smoke.py", "volume_drift.py",
                                  "k4_timeline.py", "phantom_quality.py", "int8_sites.py"])
def test_sources_name_no_jax_import(path):
    files = [REPO / path] if path.endswith(".py") else sorted((REPO / path).rglob("*.py"))
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0].rstrip(",")
                assert root not in ("jax", "jaxlib", "flax", "mudiff_tpu", "tools", "PIL",
                                    "orbax", "optax", "yaml"), f"{f}: {line}"
                if root == "matplotlib":  # only inside plot_evolution
                    assert f.name == "reports.py" and line.startswith("    "), f"{f}: {line}"


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


@pytest.mark.parametrize("value, spacing", [(1.0, 2.0**-7), (1.5, 2.0**-7), (14.0, 2.0**-4),
                                            (-14.0, 2.0**-4), (0.375, 2.0**-9), (-16.0, 2.0**-3)])
def test_chip_smoke_bf16_spacing(value, spacing):
    """``bf16_spacing`` is the gap from a bf16 number to the next one
    away from zero, at the number's magnitude."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke

    x = torch.tensor([value])
    assert float(chip_smoke.bf16_spacing(x)) == spacing
    step = torch.tensor([value + (spacing if value > 0 else -spacing)])
    assert torch.equal(step.to(torch.bfloat16).float(), step)
    assert torch.equal((x + (spacing / 4 if value > 0 else -spacing / 4)).to(torch.bfloat16)
                       .float(), x)


def test_chip_smoke_mask_distance_reads_logits_in_bf16_spacings():
    """``mask_distance`` reads the attention logits in bf16 spacings at
    the reference's mean magnitude (one spacing is 0.0625 at 13.5) and the
    BCE factors relative; ``mask_ratios`` holds them over the plain bf16
    run's own distance from fp32, each BCE factor over its own."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    ref = {"att_logit_g1": torch.full((2, 4, 4, 1), -14.0),
           "att_logit_g2": torch.full((2, 4, 4, 1), -13.0),
           **{k: torch.rand((2, 16, 16, 1), generator=g) for k in ("bce_1", "bce_2")},
           **{k: torch.randn((2, 16, 16, 1), generator=g) for k in ("pos_g1", "pos_g2")},
           **{k: torch.randn((2, 4, 4, 8), generator=g) for k in ("feat_g1", "feat_g2")}}
    for i, bce in (("g1", "bce_2"), ("g2", "bce_1")):
        ref[f"att_{i}"] = torch.sigmoid(ref[f"att_logit_{i}"]).repeat_interleave(4, 1) \
            .repeat_interleave(4, 2)
    ref["term_1"] = torch.mean(ref["att_g2"] * ref["bce_1"])
    ref["term_2"] = torch.mean(ref["att_g1"] * ref["bce_2"])
    got = dict(ref)
    got["att_logit_g1"] = ref["att_logit_g1"].clone()
    got["att_logit_g1"][0] += 0.0625  # one spacing, on half of one map's logits
    got["bce_1"] = ref["bce_1"] * 1.01
    got["term_1"] = ref["term_1"] * 1.01
    d = chip_smoke.mask_distance(got, ref)
    assert d["logit_mean_abs_spacings"] == d["logit_mean_signed_spacings"] == 0.25
    assert d["logit_max_abs_spacings"] == 1.0 and d["logit_share_differing"] == 0.25
    assert d["logit_range"] == [-14.0, -13.0]
    assert abs(d["bce_rel_err"] - 0.01) < 1e-6 and d["bce_2_rel_err"] == 0.0
    assert abs(d["term_1_rel_err"] - 0.01) < 1e-6 and d["feat_rel_err"] == 0.0
    assert d["pos_max_abs"] == 0.0 and d["G_mask_rel_err"] > 0.0
    assert chip_smoke.mask_distance(ref, ref)["logit_mean_abs_spacings"] == 0.0
    rounding = {**d, "logit_mean_abs_spacings": 0.5, "bce_1_rel_err": 0.02, "bce_2_rel_err": 1e-3}
    assert chip_smoke.mask_ratios(d, rounding) == {"logits": 0.5, "bce": d["bce_1_rel_err"] / 0.02}


def test_chip_smoke_flash_attn_entry_sums_the_volume_phase():
    """K3's entry counts the volume phase's launches; a shape that only
    the comparison ran (0 launches) adds to no time, and counts that
    disagree are refused."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rows = [
        {"kernel": "flash_attn", "launches": 0, "volume_launches": 32, "err_bf16": 0.004,
         "ms": 5.0, "plain_ms": 9.0, "library_ms": 0.5, "flop_ms": 0.14, "byte_ms": 0.005},
        {"kernel": "flash_attn", "launches": 0, "volume_launches": 0, "err_bf16": 0.006,
         "ms": 4.0, "plain_ms": 8.0, "library_ms": 0.6, "flop_ms": 0.14, "byte_ms": 0.005},
    ]
    entry = chip_smoke.kernel_summary("flash_attn", rows, 32)
    assert entry["source"] == "mudiff_torch/csrc/flash_attn_kernel.cu"
    assert entry["launches"] == 32 and entry["max_abs_err"] == 0.006
    assert abs(entry["ms"] - 160.0) < 1e-9 and abs(entry["bound_ms"] - 32 * 0.14) < 1e-9
    assert entry["bound_by"] == "operations" and "volume" in entry["per"]
    assert entry["shapes"] == 1
    with pytest.raises(AssertionError, match="add up"):
        chip_smoke.kernel_summary("flash_attn", rows, 8)


def test_chip_smoke_int8_entry_sums_the_int8_run():
    """K4's entry counts the int8 leg's sampler launches and sums, over
    them, its general path whole and apart and K1's bf16 time; a shape
    only the checks ran (the general-path one) adds nothing."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    def row(launches, path, ms, general):
        return {"kernel": "int8_conv3x3", "launches": 0, "int8_launches": launches,
                "path": path, "err_bf16": 0.0, "ms": ms, "plain_ms": 3.0,
                "library_ms": 0.2, "flop_ms": 0.05, "byte_ms": 0.01,
                "general_ms": general, "general_quantize_ms": 0.1,
                "general_gemm_ms": general - 0.1, "k1_bf16_ms": 1.0}

    rows = [row(10, "wgmma", 0.4, 0.7), row(0, "general", 0.3, 0.3)]
    entry = chip_smoke.kernel_summary("int8_conv3x3", rows, 10)
    assert entry["source"] == "mudiff_torch/csrc/int8_conv_kernel.cu"
    assert "int8" in entry["per"] and entry["paths"] == ["wgmma"]
    assert abs(entry["ms"] - 4.0) < 1e-9 and abs(entry["general_ms"] - 7.0) < 1e-9
    assert abs(entry["general_gemm_ms"] - 6.0) < 1e-9
    assert abs(entry["general_quantize_ms"] - 1.0) < 1e-9
    assert abs(entry["k1_bf16_ms"] - 10.0) < 1e-9 and entry["bound_by"] == "operations"


def test_chip_smoke_rows_count_each_path_on_its_own():
    """A shape both paths gave K1 is held and timed once and counted in
    each path's summary with that path's launches; the volume phase's
    batch-8 shapes add nothing to the main path's entry."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    log_main = [("conv3x3", ("a",))] * 3
    log_volume = [("conv3x3", ("a",)), ("conv3x3", ("b",)), ("conv3x3", ("b",))]
    counts = chip_smoke.shape_counts({"launches": log_main, "volume_launches": log_volume})
    none = dict.fromkeys(chip_smoke.PATHS, 0)
    assert counts == {"conv3x3": {("a",): {**none, "launches": 3, "volume_launches": 1},
                                  ("b",): {**none, "volume_launches": 2}}}
    times = {("a",): 1.0, ("b",): 2.0}
    rows = [{"kernel": "conv3x3", **c, "err_bf16": 0.0, "ms": times[key], "plain_ms": 0.0,
             "library_ms": 0.0, "flop_ms": 0.1, "byte_ms": 0.0}
            for key, c in counts["conv3x3"].items()]
    main = chip_smoke.kernel_summary("conv3x3", rows, 3)
    volume = chip_smoke.kernel_summary("conv3x3", rows, 3, "volume_launches")
    assert "main path" in main["per"] and abs(main["ms"] - 3.0) < 1e-12
    assert main["shapes"] == 1
    assert "volume" in volume["per"] and abs(volume["ms"] - 5.0) < 1e-12
    assert volume["shapes"] == 2


def test_chip_smoke_backward_entries_sum_the_training_phase():
    """K3's backward kernels are counted in the training phase's run."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rows = [{"kernel": "flash_attn_bwd_dq", "launches": 0, "volume_launches": 0,
             "train_launches": 8, "err_bf16": 0.002, "ms": 4.0, "plain_ms": 2.0,
             "library_ms": 0.4, "flop_ms": 0.05, "byte_ms": 0.006},
            {"kernel": "flash_attn_bwd_dq", "launches": 0, "volume_launches": 0,
             "train_launches": 0, "err_bf16": 0.004, "ms": 9.0, "plain_ms": 3.0,
             "library_ms": 9.0, "flop_ms": 0.1, "byte_ms": 0.01}]
    entry = chip_smoke.kernel_summary("flash_attn_bwd_dq", rows, 8)
    assert entry["source"] == "mudiff_torch/csrc/flash_attn_bwd_kernel.cu"
    assert "training" in entry["per"] and entry["shapes"] == 1
    assert entry["launches"] == 8 and entry["max_abs_err"] == 0.004
    assert abs(entry["ms"] - 32.0) < 1e-9 and abs(entry["bound_ms"] - 0.4) < 1e-9
    assert entry["bound_by"] == "operations"
    with pytest.raises(AssertionError, match="add up"):
        chip_smoke.kernel_summary("flash_attn_bwd_dq", rows, 4)


@pytest.mark.parametrize("kernel,function", [
    ("conv3x3", "def conv3x3_gemm("),
    ("fir_down2", "def downsample_2d_pallas("),
    ("fir_up2", "def upsample_2d_pallas("),
    # K3 is a stock kernel outside the repo: named by its call site
    ("flash_attn", "h = flash_attention("),
    # its backward, in the installed jax package
    ("flash_attn_bwd_dkv", "def _flash_attention_bwd_dkv("),
    ("flash_attn_bwd_dq", "def _flash_attention_bwd_dq("),
    # XLA-lowered on the TPU, not Pallas
    ("int8_conv3x3", "def int8_conv3x3("),
])
def test_chip_smoke_names_the_tpu_kernel_each_kernel_replaces(kernel, function):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    source, replaces = chip_smoke.SOURCES[kernel]
    assert (REPO / source).is_file()
    assert set(chip_smoke.SOURCES) == set(ops.KERNEL_WRAPPERS)
    path, line = replaces.split(":")
    root = Path(jax.__file__).resolve().parent.parent if path.startswith("jax/") else REPO
    text = (root / path).read_text().splitlines()[int(line) - 1]
    if function.startswith("def "):
        assert text.startswith(function)
    else:
        assert text.strip() == function


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
