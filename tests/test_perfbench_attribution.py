"""``perfbench/attribution.py`` and ``perfbench/tools/spans.py`` on
hand-made event lists: one case for each rule that puts a kernel down to
the port's spans, the launch count, the tool's quantities and idle-gap
names, and a golden window that the harness reads alike with and without
the port's spans in it."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.arith import Work  # noqa: E402
from perfbench.attribution import Event, attribute  # noqa: E402
from perfbench.peaks import peaks_for  # noqa: E402
from perfbench.trace import TraceView, families, read_metric, traced  # noqa: E402
from perfbench.tools import spans as spans_tool  # noqa: E402

MAIN, ENGINE = 1, 2
READERS = {"sample": ["mfu.sample", "glue_ms_per_slice.sample", "conv_roofline.sample",
                      "idle_share.sample"],
           "train": ["mfu.train", "glue_ms_per_slice.train", "conv_roofline.train",
                     "idle_share.train"]}


def span(name, s, e, thread=MAIN):
    return Event(f"mudiff.{name}", s, e, thread)


def op(name, s, e, thread=MAIN, corr=0, seq=-1, fwd=0):
    return Event(name, s, e, thread, corr, 0, seq, fwd)


def launch(t, corr, linked=0, thread=MAIN, name="cudaLaunchKernel"):
    return Event(name, t, t + 1e-6, thread, corr, linked)


def kernel(corr, s, e, name="k"):
    return Event(name, s, e, 0, corr)


def one(att):
    (k,) = att.kernels
    return k[3], k[4]


def test_launch_inside_a_span():
    spans = [span("sample.step", 0, 10), span("g1", 1, 9), span("nn.norm", 2, 3)]
    ops = [op("aten::mean", 2.1, 2.9, corr=100)]
    att = attribute([kernel(7, 20, 21)], [launch(2.5, 7, 100)], ops, spans)
    assert one(att) == ("sample.step/g1/nn.norm", 1)
    assert att.launch_calls == {"sample.step/g1/nn.norm": 1}


def test_a_span_on_the_autograd_thread_wins_over_the_autograd_link():
    spans = [span("g1", 0, 5), span("down_0_0", 1, 2),
             span("ops.conv3x3.dw", 11, 13, ENGINE)]
    ops = [op("_Conv3x3", 1.1, 1.9, seq=12),
           op("_Conv3x3Backward", 10, 14, ENGINE, corr=199, seq=12, fwd=MAIN),
           op("aten::convolution_backward", 11.5, 12.5, ENGINE, corr=200),
           op("aten::sum", 13.2, 13.8, ENGINE, corr=201)]
    calls = [launch(12, 1, 200, ENGINE), launch(13.5, 2, 201, ENGINE)]
    att = attribute([kernel(1, 20, 21), kernel(2, 21, 22)], calls, ops, spans)
    assert [(k[3], k[4]) for k in att.kernels] == [("ops.conv3x3.dw", 1),
                                                   ("g1/down_0_0/backward", 2)]


def test_a_backward_launch_reaches_the_forward_norm_by_its_sequence_number():
    spans = [span("train.g_step", 0, 30), span("train.g_step.forward", 0, 10),
             span("g1", 1, 9), span("nn.norm", 2, 3), span("train.g_step.grads", 12, 28)]
    ops = [op("aten::mul", 2.2, 2.4, seq=40),
           op("aten::mul", 5, 5.5, seq=41),
           op("autograd::engine::evaluate_function: MulBackward0", 15, 16, ENGINE, corr=298,
              seq=40, fwd=MAIN),
           op("MulBackward0", 15.1, 15.9, ENGINE, corr=299, seq=40, fwd=MAIN),
           op("aten::mul", 15.2, 15.5, ENGINE, corr=300)]
    att = attribute([kernel(5, 20, 20.004)], [launch(15.3, 5, 300, ENGINE)], ops, spans)
    assert one(att) == ("train.g_step/train.g_step.forward/g1/nn.norm/backward", 2)
    assert spans_tool.quantities(SimpleNamespace(kind="train", slices=2), att) == {
        "norm_ms_per_slice.train": pytest.approx(2.0),
        "launch_calls_per_slice.train": pytest.approx(0.5)}


def test_a_double_backward_is_followed_through_the_first_backward():
    """R1: the first backward (on the autograd thread, where no port span
    is open) recorded the ops whose nodes the second backward runs."""
    spans = [span("train.d_step", 0, 60), span("train.d_step.real", 0, 10),
             span("critic", 1, 9), span("train.d_step.r1", 12, 30),
             span("train.d_step.grads", 35, 58)]
    ops = [op("aten::leaky_relu", 3, 3.5, seq=50),
           op("LeakyReluBackward0", 20, 22, ENGINE, corr=10, seq=50, fwd=MAIN),
           op("aten::leaky_relu_backward", 20.5, 21, ENGINE, corr=11, seq=7),
           op("LeakyReluBackwardBackward0", 40, 42, ENGINE, corr=12, seq=7, fwd=ENGINE),
           op("aten::mul", 40.5, 41, ENGINE, corr=13)]
    att = attribute([kernel(9, 70, 71)], [launch(40.7, 9, 13, ENGINE)], ops, spans)
    assert one(att) == ("train.d_step/train.d_step.real/critic/backward", 2)


def test_no_link_falls_back_to_the_callers_span():
    spans = [span("train.d_step", 0, 30), span("train.d_step.grads", 10, 28)]
    ops = [op("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", 15, 16,
              ENGINE, corr=50),
           op("aten::add_", 15.2, 15.6, ENGINE, corr=51)]
    att = attribute([kernel(3, 40, 41)], [launch(15.4, 3, 51, ENGINE)], ops, spans)
    assert one(att) == ("train.d_step/train.d_step.grads", 3)


def test_unattributed_kernels():
    ops = [op("aten::randn", 1, 2, corr=5)]
    # no port span anywhere; and a kernel whose host call is not in the trace
    att = attribute([kernel(1, 5, 6), kernel(2, 6, 7)], [launch(1.5, 1, 5)], ops, [])
    assert [(k[3], k[4]) for k in att.kernels] == [("", 4), ("", 4)]
    assert att.launch_calls == {"": 1}
    assert spans_tool.quantities(SimpleNamespace(kind="sample", slices=4), att) == {
        "launch_calls_per_slice.sample": 0.25}


def test_a_graph_replay_is_one_launch_call():
    spans = [span("sample.step", 0, 10)]
    calls = [launch(1, 4, name="cudaGraphLaunch"), launch(2, 5),
             launch(2.5, 6, name="cudaMemsetAsync")]
    kernels = [kernel(4, 20, 21), kernel(4, 21, 22), kernel(4, 22, 23), kernel(5, 23, 24),
               kernel(6, 24, 25, "Memset (Device)")]
    att = attribute(kernels, calls, [], spans)
    assert att.launch_calls == {"sample.step": 2}
    assert {(k[3], k[4]) for k in att.kernels} == {("sample.step", 1)}
    assert att.device_s("sample.step") == pytest.approx(5.0)


# -- the traced window ---------------------------------------------------

def fevent(name, s_us, e_us, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=s_us, end=e_us))


KERNELS = [  # (name, start us, end us, launch us, port spans inside "g1" at the launch)
    ("conv3x3_kernel_wgmma", 1000, 1900, 950, ("down_0_0",)),
    ("reduce_kernel<512>", 1900, 2000, 1850, ("down_0_0", "nn.norm")),
    ("fir_down2_kernel", 2400, 2500, 2390, ("downsample_0",)),
    ("elementwise_kernel", 4000, 4300, 3990, ("up_0_0", "nn.norm")),
    ("sm90_xmma_wgrad_f32", 4300, 5000, 4290, ("ops.conv3x3.dw",)),
    ("vectorized_elementwise_kernel", 7000, 7600, 6990, ()),
]
G1 = (600, 4500)   # the port span "g1", us


def _window(port: bool):
    """A window of 10 ms: ``KERNELS`` on the device, a host op in each gap,
    the benchmark's spans, and (``port``) the port's spans, host side and
    device side as the profiler gives them: ``G1`` and, inside it, each
    kernel's spans a few microseconds around its launch.  Returns the
    profiler's ``events()`` and the attribution of [lo, hi] (times in us /
    1e6, as the harness reads them)."""
    events = [fevent("perfbench.window", 0, 10000), fevent("perfbench.request", 0, 10000),
              fevent("aten::cat", 2100, 2300), fevent("aten::copy_", 2600, 3800),
              fevent("python_op", 5100, 6900)]
    events += [fevent(n, s, e, DeviceType.CUDA) for n, s, e, _, _ in KERNELS]
    calls, kspans = [], []
    for i, (n, s, e, t, path) in enumerate(KERNELS):
        calls.append(launch(t / 1e6, i + 1))
        for d, name in enumerate(path if port else ()):
            lo, hi = t - 2 + d * 0.1, t + 2 - d * 0.1
            kspans.append(span(name, lo / 1e6, hi / 1e6))
            events += [fevent(f"mudiff.{name}", lo, hi, annotation=True),
                       fevent(f"mudiff.{name}", s, e, DeviceType.CUDA, True)]
    if port:
        # "g1", and a norm open through the middle of the gap before "elementwise"
        kspans += [span("g1", G1[0] / 1e6, G1[1] / 1e6), span("nn.norm", 3000 / 1e6, 3300 / 1e6)]
        events += [fevent("mudiff.g1", *G1, annotation=True),
                   fevent("mudiff.g1", 1000, 4300, DeviceType.CUDA, True),
                   fevent("mudiff.nn.norm", 3000, 3300, annotation=True)]
    kernels = [kernel(i + 1, s / 1e6, e / 1e6, n) for i, (n, s, e, _, _) in enumerate(KERNELS)]
    return events, attribute(kernels, calls, [], kspans, 0.0, 0.01)


def _harness(events, monkeypatch):
    """The harness's own ``traced`` over a profiler that gives ``events``."""
    import torch

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    holder = {}
    with traced(holder):
        pass
    return holder


def _view(kind, holder):
    return TraceView(kind, holder["kernels"], holder["window_s"], 8,
                     Work(1e12, 0.0, [(1e11, 1e8, False)]), peaks_for("NVIDIA H100 80GB HBM3"),
                     families(ROOT), holder["gaps"])


def test_golden_window_reads_alike_with_and_without_the_ports_spans(monkeypatch):
    """The port's spans (host ranges and their device-side images) move
    none of the numbers the harness reads from a window."""
    with_port = _harness(_window(port=True)[0], monkeypatch)
    without = _harness(_window(port=False)[0], monkeypatch)
    assert with_port["kernels"] == without["kernels"] and len(without["kernels"]) == 6
    assert with_port["window_s"] == without["window_s"]
    assert sorted(s for _, s in with_port["gaps"]) == sorted(s for _, s in without["gaps"])
    for kind, names in READERS.items():
        a, b = _view(kind, with_port), _view(kind, without)
        assert a.breakdown()["device_ops"] == b.breakdown()["device_ops"]
        for name in names:
            assert read_metric(ROOT, name, a) == read_metric(ROOT, name, b) is not None, name


def test_the_tools_gap_names_put_the_port_span_into_the_harness_names(monkeypatch):
    events, att = _window(port=True)
    tv = _view("train", _harness(events, monkeypatch))
    named = dict(spans_tool.port_gaps(tv, att, events))
    plain = {}
    for name, sec in _harness(_window(port=False)[0], monkeypatch)["gaps"]:
        plain[name] = plain.get(name, 0.0) + sec
    assert sorted(named.values()) == sorted(plain.values())     # the same gaps
    assert plain == {"request/python": pytest.approx(0.0034),
                     "request/aten::cat": pytest.approx(0.0004),
                     "request/aten::copy_": pytest.approx(0.0015),
                     "request/python_op": pytest.approx(0.002)}
    # the harness itself takes the outermost port span for the host op
    assert {n for n, _ in _harness(events, monkeypatch)["gaps"]} == {
        "request/python", "request/mudiff.g1", "request/python_op"}
    # 0-1 ms and 7.6-10 ms: no kernel's launching thread had a port span
    # open at the middle; 2.0-2.4 ms: "g1"; 2.5-4.0 ms: the norm inside it
    assert named == {"request/python": pytest.approx(0.0034),
                     "request/g1/aten::cat": pytest.approx(0.0004),
                     "request/nn.norm/aten::copy_": pytest.approx(0.0015),
                     "request/python_op": pytest.approx(0.002)}


def test_the_tools_quantities_and_lines(monkeypatch):
    events, att = _window(port=True)
    tv = _view("train", _harness(events, monkeypatch))
    q = spans_tool.quantities(tv, att)
    assert q == {"norm_ms_per_slice.train": pytest.approx(0.4 / 8),
                 "k1_dw_ms_per_slice.train": pytest.approx(0.7 / 8),
                 "launch_calls_per_slice.train": pytest.approx(6 / 8)}   # no critic here
    assert set(spans_tool.quantities(_view("sample", _harness(events, monkeypatch)), att)) == {
        "norm_ms_per_slice.sample", "launch_calls_per_slice.sample"}
    shares = att.rule_shares()
    assert shares[1] == pytest.approx(2.1 / 2.7) and shares[4] == pytest.approx(0.6 / 2.7)
    assert {k[3] for k in att.kernels} == {
        "g1/down_0_0", "g1/down_0_0/nn.norm", "g1/downsample_0",
        "g1/up_0_0/nn.norm", "g1/ops.conv3x3.dw", ""}
    lines = spans_tool.report_lines(tv, att, events)
    assert lines[0].startswith("span g1/down_0_0 0.9")
    assert any(x.startswith("attributed rule1 0.77") and x.endswith("launch_calls 6")
               for x in lines)
    assert any(x.startswith("quantity k1_dw_ms_per_slice.train 0.087") for x in lines)
    assert any(x.startswith("gap ") and x.endswith("request/nn.norm/aten::copy_")
               for x in lines)
    rec = spans_tool.records(tv, att)
    assert rec["device_ms"]["g1/ops.conv3x3.dw"] == {
        "sm90_xmma_wgrad_f32 (rule 1)": pytest.approx(0.7)}
    # the parent's program opens no port span: nothing but the launches
    _, plain_att = _window(port=False)
    assert spans_tool.quantities(tv, plain_att) == {
        "launch_calls_per_slice.train": pytest.approx(6 / 8)}
