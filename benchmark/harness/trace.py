"""The device trace of a window: torch.profiler on the card (CUPTI
activity only, so the host's calls are not slowed by op recording), read
into kernel intervals on the wall clock that the host spans map onto.

`busy_s` is the union of every device operation (kernels, copies, sets)
inside the window; the idle gaps between them are named by the host
spans that were open across them, so a gap reads as what the clients
were doing while the card waited.
"""

from __future__ import annotations

import collections
import functools
import glob
import os
import re

from . import manifest

_IDENT = re.compile(r"\s*(\w+)")


def _global_names(text: str):
    """Names of the `__global__` functions in CUDA source `text`: the
    first identifier after the qualifier that is neither `void` nor
    `__launch_bounds__` (whose balanced parentheses are skipped)."""
    for m in re.finditer(r"__global__", text):
        i = m.end()
        while True:
            w = _IDENT.match(text, i)
            if not w:
                break
            i = w.end()
            if w.group(1) == "__launch_bounds__":
                j = text.index("(", i)
                depth = 0
                for k in range(j, len(text)):
                    depth += {"(": 1, ")": -1}.get(text[k], 0)
                    if depth == 0:
                        i = k + 1
                        break
            elif w.group(1) != "void":
                yield w.group(1)
                break


def own_kernels(root: str = manifest.ROOT) -> frozenset:
    """Names of the program's own kernels: every `__global__` function in
    its CUDA sources and every `@triton.jit` function in its Python."""
    names = set()
    pkg = os.path.join(root, "seismic_tpu_torch")
    for path in glob.glob(os.path.join(pkg, "csrc", "*.cu*")):
        with open(path) as f:
            names.update(_global_names(f.read()))
    jit = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
    for path in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True):
        with open(path) as f:
            names.update(jit.findall(f.read()))
    return frozenset(names)


@functools.lru_cache(maxsize=None)
def short_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters: `void at::native::foo<...>(...)` ->
    `at::native::foo`."""
    s = name.strip().replace("(anonymous namespace)", "{anonymous}")
    if s.startswith("void "):
        s = s[5:]
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or s[:80]


def base_name(name: str) -> str:
    return short_name(name).rsplit("::", 1)[-1]


class Trace:
    """Device operations of one traced window: `ops` [(name, start ns,
    end ns)] on the wall clock, clipped to [w0, w1]."""

    def __init__(self, ops, w0: int, w1: int, own: frozenset):
        self.ops = sorted((n, max(s, w0), min(e, w1)) for n, s, e in ops
                          if e > w0 and s < w1)
        self.w0, self.w1 = w0, w1
        self.own = own
        self.window_s = (w1 - w0) / 1e9
        self.busy = self._union()
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

    def _union(self):
        out = []
        for s, e in sorted((s, e) for _, s, e in self.ops):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def seconds(self, pred) -> float:
        """Summed time of the operations whose name `pred` accepts."""
        return sum(e - s for n, s, e in self.ops if pred(n)) / 1e9

    def kernel_s(self, kernel: str) -> float:
        return self.seconds(lambda n: base_name(n) == kernel)

    def is_own(self, name: str) -> bool:
        return base_name(name) in self.own

    def top_ops(self, n: int = 10):
        acc = collections.Counter()
        for name, s, e in self.ops:
            acc[short_name(name)[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in acc.most_common(n)]

    def gaps(self):
        """[(start ns, end ns)] of the window in which no operation ran."""
        out, t = [], self.w0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def idle_by_host(self, spans, n: int = 10):
        """The idle time named by the host spans open across it: each gap
        split at the spans' edges, each piece named by the sorted names of
        the client spans open over it ("idle" where none is). One sweep
        over the spans' edges and the gaps, both in time order."""
        edges = sorted((t, d, name) for name, c, s, e in spans
                       if c >= 0 and e > s
                       for t, d in ((s, 1), (e, -1)))
        open_ = collections.Counter()
        acc = collections.Counter()
        i = 0

        def label():
            return "+".join(sorted(open_.elements())) or "idle"

        for g0, g1 in self.gaps():
            while i < len(edges) and edges[i][0] <= g0:
                open_[edges[i][2]] += edges[i][1]
                i += 1
            t = g0
            while i < len(edges) and edges[i][0] < g1:
                if edges[i][0] > t:
                    acc[label()] += (edges[i][0] - t) / 1e9
                    t = edges[i][0]
                open_[edges[i][2]] += edges[i][1]
                i += 1
            acc[label()] += (g1 - t) / 1e9
        return [[k, v] for k, v in acc.most_common(n)]


def start():
    """A profiler recording the card's activity, started."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof, w0_wall: int, w1_wall: int, own: frozenset) -> Trace:
    """Stop `prof` and read its device operations inside [w0, w1] (wall
    clock ns). Raises RuntimeError where it recorded none."""
    import torch

    prof.stop()
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    trace = Trace(ops, w0_wall, w1_wall, own)
    if trace.busy_s <= 0:
        raise RuntimeError("the profiler recorded no device time in the "
                           "window")
    return trace
