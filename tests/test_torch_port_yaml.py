"""The port's YAML experiment layer and its small tools, against PyYAML
and the JAX package, on the CPU.

``utils/yaml_lite`` (the card's machine has no PyYAML) must give what
``yaml.safe_load`` gives on the three shipped experiment files and on
fixtures of each feature they use (anchors on mappings, ``<<`` merges
with overrides, flow lists, YAML 1.1 scalars such as ``1e-4`` against
``1.0e-4`` and ``yes`` / ``on`` / ``~``, quoted strings), and refuse what
lies outside its subset.  Every experiment's ``train_args`` and
``test_args`` become the JAX runner's config, field by field.  Beside
them: ``check_pipeline`` on the shipped files and on a broken one (the
JAX package's messages), ``find_modality_files`` on BraTS, BraTS-2023 and
ISLES names, and the model registry's names.
"""

import glob
import os

import pytest
import yaml

from mudiff_tpu.cli import check_pipeline as jcheck
from mudiff_tpu.cli import predict_volume_wrapper as jwrapper
from mudiff_tpu.cli.run import _IGNORED_KEYS as JAX_IGNORED
from mudiff_tpu.cli.run import _config_from_yaml as jax_config_from_yaml
from mudiff_tpu.models import registry as jregistry
from mudiff_torch import config
from mudiff_torch.cli import check_pipeline, predict_volume_wrapper
from mudiff_torch.models import registry
from mudiff_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(glob.glob(os.path.join(REPO, "experiments", "*.yaml")))

FIXTURES = {
    "scalars": (
        "a: 1e-4\nb: 1.0e-4\nc: yes\nd: on\ne: ~\nf: null\ng:\nh: 'it''s'\n"
        "i: \"tab\\there\"\nj: off\nk: 0x1F\nl: 010\nm: 1_000\nn: .inf\no: -.inf\n"
        "p: 1:30\nq: +12\nr: 09\ns: 1.\nt: .5\nu: True\nv: 'yes'\nw: NO\nx: 0b101\n"
        "y: -2.5e+3\nz: plain text, with comma\n"),
    "flow lists": "a: [1, 2.5, abc, 'q', \"d\", 1e3, 1.0e3, ~, yes]\nb: []\nc: [16]\n",
    "anchored mapping and merge": (
        "base: &b\n  x: 1\n  y: [1, 2]\n  z: keep\nchild:\n  <<: *b\n  y: 3\n"
        "child2:\n  y: 9\n  <<: *b\nshared: *b\n"),
    "anchored lists and scalars": "l: &l\n- 1\n- 2\nm: *l\nn: &s hello\no: *s\np: &f [4, 5]\nq: *f\n",
    "sequences of mappings": (
        "top:\n- a: 1\n  b:\n  - x\n  - y\n  c: # a comment\n    d: 2\n- - 1\n  - 2\n"
        "- plain text # trailing\n- 'q # not a comment'\n-\n  k: v\n"),
    "comments and urls": (
        "# full line\nkey: value with spaces   # trailing\nurl: http://x.y/z#frag\n"
        "neg: -1\n  # indented comment\nempty_list_key:\n- 0\n"),
}

REFUSED = {
    "tag": "a: !!str 1\n",
    "block scalar": "a: |\n  x\n",
    "flow mapping": "a: {b: 1}\n",
    "multi-line flow": "a: [1,\n  2]\n",
    "document marker": "---\na: 1\n",
    "timestamp": "a: 2001-12-14\n",
    "nested inline mapping": "a: b: c\n",
    "bad indentation": "a:\n  b: 1\n   c: 2\n",
    "nested flow": "a: [[1]]\n",
    "unknown alias": "a: *nope\n",
    "multi-line plain": "a: 1\n  b: 2\n",
    "tab": "\ta: 1\n",
    "unterminated quote": "a: 'x\n",
    "merge of a scalar": "a: &s 1\nb:\n  <<: *s\n",
}


@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_yaml_lite_reads_the_shipped_experiments_as_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_lite.load(path) == want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_yaml_lite_matches_pyyaml_on_fixtures(name):
    text = FIXTURES[name]
    got, want = yaml_lite.loads(text), yaml.safe_load(text)
    assert repr(got) == repr(want)  # types too: 1e-4 a str, 1.0e-4 a float


def test_yaml_1_1_scalars():
    doc = yaml_lite.loads(FIXTURES["scalars"])
    assert doc["a"] == "1e-4" and doc["b"] == 1.0e-4
    assert doc["c"] is True and doc["d"] is True and doc["j"] is False and doc["w"] is False
    assert doc["e"] is None and doc["f"] is None and doc["g"] is None
    assert (doc["k"], doc["l"], doc["m"], doc["p"], doc["x"]) == (31, 8, 1000, 90, 5)
    assert doc["r"] == "09" and doc["v"] == "yes" and doc["h"] == "it's"


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_yaml_lite_refuses_what_is_outside_its_subset(name):
    with pytest.raises(yaml_lite.YamlError, match="line"):
        yaml_lite.loads(REFUSED[name])


@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_config_from_yaml_matches_jax_for_every_experiment(path):
    doc = yaml_lite.load(path)
    assert config._IGNORED_KEYS == JAX_IGNORED
    assert doc["experiments"]
    for exp in doc["experiments"]:
        for part in ("train_args", "test_args"):
            args = (exp[part], doc["data_path"], doc["output_root"], exp["exp_name"],
                    exp["target"])
            got = config._config_from_yaml(*args).to_dict()
            want = jax_config_from_yaml(*args).to_dict()
            assert got == want, (exp["exp_name"], part)
            assert got["target_modality"] == exp["target"]


def test_load_experiment_names_what_the_file_has():
    doc, exp = config.load_experiment(EXPERIMENTS[0], "synthesize_T1CE")
    assert exp["target"] == "T1CE" and doc["data_path"] == "/data/BRATS"
    with pytest.raises(ValueError, match="synthesize_FLAIR"):
        config.load_experiment(EXPERIMENTS[0], "nope")


@pytest.mark.parametrize("path", EXPERIMENTS, ids=os.path.basename)
def test_check_pipeline_passes_on_the_shipped_experiments(path, capsys):
    assert check_pipeline.check(path, device="cpu") == []
    out = capsys.readouterr().out
    assert "runbook command valid: python -m mudiff_torch.cli.run" in out
    assert "LPIPS wired" in out


def test_check_pipeline_reports_the_jax_errors_on_a_broken_file(tmp_path, capsys):
    broken = tmp_path / "broken.yaml"
    broken.write_text(
        "data_path: /nowhere\noutput_root: ./r\nexperiments:\n"
        "- exp_name: a\n  target: T1CE\n  train_args:\n    image_size: 64\n"
        "- exp_name: a\n  train_args:\n    image_size: 64\n  test_args:\n    seed: 1\n"
        "- exp_name: b\n  target: T1\n  train_args:\n    image_size: 64\n"
        "    num_channels: 1\n    num_channels_dae: 16\n    ch_mult: [1, 2]\n"
        "    num_res_blocks: 1\n    num_timesteps: 4\n    batch_size: 2\n    num_epoch: 1\n"
        "    lr_g: 1.0e-4\n    lr_d: 1.0e-4\n    dp: 2\n  test_args: {}\n".replace(
            "  test_args: {}\n", "  test_args:\n    seed: 1\n"))
    want = [e for e in jcheck.check(str(broken)) if not e.startswith("missing dependency")]
    got = check_pipeline.check(str(broken), device="cpu")
    capsys.readouterr()
    # a dp: 2 experiment passes as it passes the JAX check (the mesh is
    # checked against the world at run time, by parallel.init_mesh)
    assert want and set(got) == set(want)
    with pytest.raises(SystemExit):
        check_pipeline.main(["-c", str(broken)], device="cpu")
    assert "[FAIL] duplicate experiment names" in capsys.readouterr().out


def test_check_pipeline_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    errors = check_pipeline.check(EXPERIMENTS[0])
    capsys.readouterr()
    assert any("no CUDA device visible" in e for e in errors)


def test_check_pipeline_sees_runbook_drift(tmp_path, capsys):
    readme = tmp_path / "README.md"
    readme.write_text(f"{check_pipeline.README_SECTION}\n\n```bash\n"
                      "python -m mudiff_torch.cli.run -c x.yaml --no-such-flag\n"
                      "python -m mudiff_torch.cli.nothing --x\n```\n")
    errors = check_pipeline.check_runbook(lambda msg: None, str(readme))
    assert any("no longer declares ['--no-such-flag']" in e for e in errors)
    assert any("mudiff_torch.cli.nothing does not resolve" in e for e in errors)


NAMES = [
    # BraTS 2019-2021
    ["BraTS19_001_flair.nii.gz", "BraTS19_001_t1.nii.gz", "BraTS19_001_t1ce.nii.gz",
     "BraTS19_001_t2.nii.gz", "BraTS19_001_seg.nii.gz"],
    # BraTS 2023
    ["BraTS-GLI-00001-000-t1c.nii.gz", "BraTS-GLI-00001-000-t1n.nii.gz",
     "BraTS-GLI-00001-000-t2f.nii.gz", "BraTS-GLI-00001-000-t2w.nii.gz"],
    # ISLES 2015 SISS
    ["VSD.Brain.XX.O.MR_Flair.70614.nii", "VSD.Brain.XX.O.MR_T1.70615.nii",
     "VSD.Brain.XX.O.MR_T2.70616.nii", "VSD.Brain.XX.O.MR_DWI.70617.nii"],
    # mixed spellings
    ["p_T1Gd.nii.gz", "p_T1w.nii", "p_T2W.nii.gz", "p_FLAIR.nii.gz", "notes.txt"],
]


@pytest.mark.parametrize("names", NAMES, ids=lambda n: n[0].split("_")[0][:12])
def test_find_modality_files_matches_jax(names, tmp_path):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = predict_volume_wrapper.find_modality_files(str(tmp_path))
    assert got == jwrapper.find_modality_files(str(tmp_path))
    assert len(got) >= 3


def test_registry_resolves_the_jax_names():
    assert sorted(registry._MODELS) == sorted(jregistry._MODELS)
    from mudiff_torch.models import (DiscriminatorImgLarge, DiscriminatorLarge,
                                     DiscriminatorSmall, NCSNppGenerator)

    assert registry.get_model("ncsnpp") is NCSNppGenerator
    assert registry.get_model("discriminator_large") is DiscriminatorLarge
    cfg = config.MuDiffConfig(image_size=32, num_channels=1, num_channels_dae=16,
                              ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,))
    assert registry.get_model("ncsnpp_adaptive")(cfg).adaptive
    assert registry.get_model("discriminator_small") is DiscriminatorSmall
    assert registry.get_model("discriminator_img_large") is DiscriminatorImgLarge
    with pytest.raises(ValueError, match="Already registered"):
        registry.register_model(NCSNppGenerator, name="ncsnpp")
