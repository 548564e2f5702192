"""Each device kernel of the traced window put down to the port's spans.

The port opens ``mudiff.<name>`` ranges (``mudiff_torch/utils/
profiling.py`` ``span``) around its parts while a profiler records.  A
kernel runs on the device, long after and apart from the host code that
launched it; what ties the two is the host call that launched it (the
CUDA runtime or driver launch, graph launch or copy whose CUPTI
correlation id the kernel carries).  Its path is the first of:

1. the port spans open on the launching thread at the launch (the
   spans a backward opens on the autograd thread count here:
   ``ops.conv3x3.dw``, ``remat.<region>``);
2. else the autograd link: from the ops open around the launch, the
   innermost backward node (an op with a forward thread and a sequence
   number) leads to the forward op of that number on that thread; the
   port spans open there, with ``backward`` appended.  When none are
   open there (a double backward's first pass ran on the autograd
   thread), the forward op is followed again, up to ``MAX_HOPS`` times;
3. else the port spans open on any thread at the launch, the innermost
   of them (in practice the caller's ``train.*.grads``);
4. else none: unattributed.

The same pass counts the launch calls in the window (kernel and graph
launches: a graph replay is one call) and puts each down to a path the
same way.  ``from_profile`` reads a ``torch.profiler`` run's raw events;
``attribute`` works on plain records, so the tests hand it event lists.
``perfbench/tools/spans.py`` runs a cell's traced window through it and
prints the span table; the harness does not call it yet (PERF.md §7).
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

PORT = "mudiff."
BACKWARD = "backward"
MAX_HOPS = 4
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaLaunchCooperativeKernelMultiDevice", "cuLaunchKernel", "cuLaunchKernelEx",
    "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch"})
_API = re.compile(r"^cu(da)?[A-Z]")


class Event(NamedTuple):
    """One event of the window, times in seconds on the profiler's clock
    (the clock of ``TraceView.kernels``)."""

    name: str
    start: float
    end: float
    thread: int = 0       # the profiler's thread id (ops, spans, host calls)
    corr: int = 0         # kernels and host calls: the CUPTI correlation id; ops: the op's id
    linked: int = 0       # host calls: the id of the op open at the call (0: none)
    seq: int = -1         # ops: autograd sequence number
    fwd_thread: int = 0   # backward nodes: the thread of their forward


class Attribution:
    """What the pass found: each kernel with its path and rule, the launch
    calls by path, and the port spans' host seconds by path."""

    def __init__(self, kernels: List[Tuple[str, float, float, str, int]],
                 launch_calls: Dict[str, int], host_s: Dict[str, float], port_span_at):
        self.kernels = kernels            # (name, start s, end s, path, rule 1-4)
        self.launch_calls = launch_calls  # {path ("" unattributed): calls}
        self.host_s = host_s              # {path: host seconds of the spans}
        self._port_span_at = port_span_at

    def device_s(self, match: str) -> float:
        """Device seconds of the kernels whose path holds the span ``match``."""
        return sum(e - s for _, s, e, p, _ in self.kernels if match in p.split("/"))

    def has_span(self, match: str) -> bool:
        return any(match in p.split("/") for _, _, _, p, _ in self.kernels)

    def total_launch_calls(self) -> int:
        return sum(self.launch_calls.values())

    def rule_shares(self) -> Dict[int, float]:
        """{rule: share of the kernels' device time}."""
        total = sum(e - s for _, s, e, _, _ in self.kernels)
        out = dict.fromkeys((1, 2, 3, 4), 0.0)
        for _, s, e, _, r in self.kernels:
            out[r] += e - s
        return {r: v / total if total > 0 else 0.0 for r, v in out.items()}

    def table(self, top: int = 40) -> List[Tuple[str, float, int, float]]:
        """(path, device s, launch calls, host s), the ``top`` by device time."""
        dev: Dict[str, float] = {}
        for _, s, e, p, _ in self.kernels:
            dev[p] = dev.get(p, 0.0) + (e - s)
        paths = set(dev) | set(self.launch_calls) | set(self.host_s)
        rows = [(p or "(unattributed)", dev.get(p, 0.0), self.launch_calls.get(p, 0),
                 self.host_s.get(p, 0.0)) for p in paths]
        return sorted(rows, key=lambda r: (-r[1], -r[3], r[0]))[:top]

    def port_span_at(self, kernel_start: float, t: float) -> Optional[str]:
        """The innermost port span open at ``t`` on the thread that launched
        the kernel starting at ``kernel_start`` (None: none)."""
        return self._port_span_at(kernel_start, t)


class _Nest:
    """Properly nested intervals of one thread: the innermost open at a
    time, and the chain of those around it."""

    def __init__(self, items: Sequence[Event]):
        self.items = sorted(items, key=lambda x: (x.start, -x.end))
        self.starts = [x.start for x in self.items]
        self.index = {id(x): i for i, x in enumerate(self.items)}
        self.parent: List[int] = []
        stack: List[int] = []
        for i, x in enumerate(self.items):
            while stack and self.items[stack[-1]].end < x.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i].end < t:
            i = self.parent[i]
        return i

    def chain(self, i: int) -> List[Event]:
        """The item ``i`` and those around it, innermost first."""
        out = []
        while i >= 0:
            out.append(self.items[i])
            i = self.parent[i]
        return out


def _path(chain: List[Event]) -> str:
    return "/".join(x.name[len(PORT):] for x in reversed(chain))


def attribute(kernels: Sequence[Event], calls: Sequence[Event], ops: Sequence[Event],
              spans: Sequence[Event], lo: float = -float("inf"),
              hi: float = float("inf")) -> Attribution:
    """Put each kernel (clipped to [lo, hi]) and each launch call started
    in [lo, hi] down to a path of port spans (the module's rules)."""
    threads = {x.thread for x in spans} | {x.thread for x in ops}
    span_nest = {t: _Nest([x for x in spans if x.thread == t]) for t in threads}
    op_nest = {t: _Nest([x for x in ops if x.thread == t]) for t in threads}
    op_of = {x.corr: x for x in ops if x.corr}
    fwd_ops: Dict[Tuple[int, int], List[Event]] = {}
    for x in ops:
        if x.seq >= 0:
            fwd_ops.setdefault((x.thread, x.seq), []).append(x)
    for v in fwd_ops.values():
        v.sort(key=lambda x: x.start)

    def spans_at(thread: int, t: float) -> List[Event]:
        nest = span_nest.get(thread)
        return nest.chain(nest.innermost(t)) if nest else []

    def ops_around(thread: int, t: float, linked: int) -> List[Event]:
        nest = op_nest.get(thread)
        if nest is None:
            return []
        op = op_of.get(linked)
        if op is not None and op.thread == thread:
            return nest.chain(nest.index[id(op)])
        return nest.chain(nest.innermost(t))

    def forward_of(node: Event) -> Optional[Event]:
        cands = fwd_ops.get((node.fwd_thread, node.seq), [])
        i = bisect.bisect_left([x.start for x in cands], node.start) - 1
        return cands[i] if i >= 0 else None

    def path_of(call: Event) -> Tuple[str, int]:
        chain = spans_at(call.thread, call.start)
        if chain:
            return _path(chain), 1
        around = ops_around(call.thread, call.start, call.linked)
        for _ in range(MAX_HOPS):
            node = next((x for x in around if x.fwd_thread > 0 and x.seq >= 0), None)
            fwd = forward_of(node) if node is not None else None
            if fwd is None:
                break
            chain = spans_at(fwd.thread, fwd.start)
            if chain:
                return _path(chain) + "/" + BACKWARD, 2
            around = op_nest[fwd.thread].chain(op_nest[fwd.thread].index[id(fwd)])
        best = None
        for t in span_nest:
            chain = spans_at(t, call.start)
            if chain and (best is None or chain[0].start > best[0].start):
                best = chain
        if best:
            return _path(best), 3
        return "", 4

    call_of = {c.corr: c for c in calls}
    paths: Dict[int, Tuple[str, int]] = {}
    launch_calls: Dict[str, int] = {}
    for c in calls:
        if c.name in LAUNCH_CALLS and lo <= c.start <= hi:
            paths[c.corr] = path_of(c)
            p = paths[c.corr][0]
            launch_calls[p] = launch_calls.get(p, 0) + 1
    out = []
    thread_of: Dict[float, int] = {}
    for k in kernels:
        if k.end <= lo or k.start >= hi:
            continue
        s, e = max(k.start, lo), min(k.end, hi)
        call = call_of.get(k.corr)
        if call is None:
            out.append((k.name, s, e, "", 4))
            continue
        if call.corr not in paths:
            paths[call.corr] = path_of(call)
        out.append((k.name, s, e, *paths[call.corr]))
        thread_of.setdefault(s, call.thread)

    host_s: Dict[str, float] = {}
    for t, nest in span_nest.items():
        for i, x in enumerate(nest.items):
            if x.start >= lo and x.end <= hi:
                p = _path(nest.chain(i))
                host_s[p] = host_s.get(p, 0.0) + (x.end - x.start)

    def port_span_at(kernel_start: float, t: float) -> Optional[str]:
        thread = thread_of.get(kernel_start)
        chain = spans_at(thread, t) if thread is not None else []
        return chain[0].name[len(PORT):] if chain else None

    return Attribution(out, launch_calls, host_s, port_span_at)


def split_events(raw, base_ns: int):
    """(kernels, calls, ops, spans) of a profiler run's raw (kineto)
    events, at the times ``torch.profiler``'s ``events()`` give them
    (microseconds from ``base_ns``, as seconds)."""
    from torch.autograd import DeviceType

    kernels, calls, ops, spans = [], [], [], []
    for ev in raw:
        name = ev.name()
        s = (ev.start_ns() - base_ns) / 1000 / 1e6
        e = (ev.end_ns() - base_ns) / 1000 / 1e6
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation() or name.startswith(("Optimizer.", PORT,
                                                               "perfbench."))):
                kernels.append(Event(name, s, e, ev.start_thread_id(), ev.correlation_id()))
        elif ev.device_type() != DeviceType.CPU or ev.is_async():
            continue
        elif name.startswith(PORT):
            spans.append(Event(name, s, e, ev.start_thread_id()))
        elif _API.match(name):
            calls.append(Event(name, s, e, ev.start_thread_id(), ev.correlation_id(),
                               ev.linked_correlation_id()))
        elif not name.startswith("perfbench."):
            ops.append(Event(name, s, e, ev.start_thread_id(), ev.correlation_id(), 0,
                             ev.sequence_nr(), ev.fwd_thread_id()))
    return kernels, calls, ops, spans


def from_profile(prof, lo: float, hi: float) -> Optional[Attribution]:
    """The attribution of a finished ``torch.profiler.profile`` over the
    window [lo, hi] (None where the profiler keeps no raw events)."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        return None
    return attribute(*split_events(results.events(), results.trace_start_ns()), lo, hi)
