"""Each cell's control, at a size a CPU test run holds:
``perfbench/tools/control.py``'s readings (the ones the limits were set
from on the card, at the cells' own sizes), taken here on tiny
configurations with the port's plain versions.  The sound run passes the
cell's limits; a sampling control reads three times the sound run's
number or more (what makes an upper reading); the training control and
the half-batch fault fail the cell's limits."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "perfbench" / "tools"))

from perfbench import core  # noqa: E402
from perfbench.tests.tiny import tiny_config, tiny_traffic  # noqa: E402


def _ctx(cell, config, traffic):
    manifest, c, _, _, limits = core.find_cell(ROOT, cell)
    return core.Ctx(ROOT, c, config, traffic, copy.deepcopy(limits), 0, 0.0, False, "cpu", 0.0)


def _fails(ctx, readings):
    checks = core.decide(ctx.limits, readings)
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", ["nf128.sample.b8.bf16", "nf64.sample.b32.w8a8s",
                                  "nf64.sample.b32.bf16"])
def test_sampling_control_fails(cell):
    import control

    _, c, _, _, _ = core.find_cell(ROOT, cell)
    ctx = _ctx(cell, tiny_config(c["config"]), tiny_traffic(c["traffic"]))
    (row,) = control.sample_cell(ctx, [424242], {424242})
    assert not _fails(ctx, row["sound"]), row
    # the limits are the cells' own sizes'; at this size the control reads
    # what sets an upper reading: three times the sound run's, or more
    for name in ctx.limits["limits"]:
        assert row["control"][name] >= 3.0 * row["sound"][name], (name, row)


def test_training_control_fails():
    import control

    ctx = _ctx("nf128.train.b2", tiny_config("mudiff_nf128", image_size=64, lazy_reg=4),
               tiny_traffic("train.b2", batch=2))
    (row,) = control.train_cell(ctx, [525252], {525252})
    assert not _fails(ctx, row["sound"]), row
    assert _fails(ctx, row["control"]), row
    assert _fails(ctx, row["half_batch"]), row
