"""The profiler's trace of a steady stretch of batches, reduced.

`Trace.record(step, batches)` runs `step` over batches under
torch.profiler, with the benchmark's own spans (`copy_in`, `replay`,
`readback`, as record_function ranges) on the same clock as the device's
operations (kernels, copies, sets: every event the profiler reports on the
device). From them:

  * `window_s`: from the first span's start to the last one's end;
  * `busy_s`: the union of the device's operations inside that window;
  * `device_s(pattern)`: the summed time of the operations whose name
    matches `pattern`;
  * `top_ops`: the device operations that took most time, by name;
  * `idle_by_span`: the device's idle time inside the window, by the span
    the host was in (`between` outside every span).
"""
from __future__ import annotations

import re

SPANS = ("copy_in", "replay", "readback")


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def short_name(name: str, most: int = 120) -> str:
    """A kernel's demangled name without its return type and its argument
    list, cut to `most` characters; another operation's name (a copy's, a
    set's: a space before its parenthesis) as it is."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if re.match(r"[A-Za-z0-9_>]", name[i - 1]):
                    name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:most]


class Trace:
    def __init__(self):
        self.ops = []      # (name, start_ns, end_ns) on the device
        self.spans = []    # (name, start_ns, end_ns) on the host
        self.batches = 0

    def record(self, step, batches: int):
        """Profiles `batches` calls of step(k, span), where `span(name)` is a
        context manager for one of SPANS."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(batches):
                step(k, record_function)
            torch.cuda.synchronize()
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            item = (e.name(), start, start + _ns(e, "duration"))
            if e.device_type() == DeviceType.CUDA:
                # the profiler mirrors each span on the device's timeline
                if e.name() not in SPANS:
                    self.ops.append(item)
            elif e.name() in SPANS:
                self.spans.append(item)
        self.ops.sort(key=lambda x: x[1])
        self.spans.sort(key=lambda x: x[1])
        self.batches = batches
        if not self.ops:
            raise RuntimeError("the profiler recorded no operation on the device")

    @property
    def window(self):
        return self.spans[0][1], self.spans[-1][2]

    @property
    def window_s(self) -> float:
        w0, w1 = self.window
        return (w1 - w0) * 1e-9

    def busy_intervals(self):
        """The union of the device's operations, clipped to the window."""
        w0, w1 = self.window
        merged = []
        for _, s, e in self.ops:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n)) * 1e-9

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e in self.ops:
            n = short_name(n)
            by[n] = by.get(n, 0) + (e - s)
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_span(self):
        """Idle seconds of the device inside the window, by the host span
        they fall in (the spans follow one another on one thread)."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < w1:
            gaps.append((at, w1))
        by = dict.fromkeys(SPANS + ("between",), 0)
        i = 0
        for g0, g1 in gaps:
            while i < len(self.spans) and self.spans[i][2] <= g0:
                i += 1
            covered, k = 0, i
            while k < len(self.spans) and self.spans[k][1] < g1:
                name, s, e = self.spans[k]
                part = min(g1, e) - max(g0, s)
                if part > 0:
                    by[name] += part
                    covered += part
                k += 1
            by["between"] += (g1 - g0) - covered
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1]) if t > 0]
