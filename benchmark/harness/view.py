"""What a per-layer metric's reader is given: one run's window as the
benchmark saw it (host spans, the batches served, the device trace, the
set-up spans, launch counts) and the arithmetic the readers share."""

from __future__ import annotations

from . import manifest, peaks


class RunView:
    def __init__(self, program: str, spans, served, window_s: float, trace,
                 setup: dict, launches: dict, facts,
                 bench_dir: str = manifest.BENCH_DIR):
        self.program = program  # the entry's program: "grouped", "engine"
        self.spans = spans  # [(name, client, t0 ns, t1 ns)] of the window
        self.served = served
        self.batches = len(served)
        self.window_s = window_s
        self.trace = trace  # harness.trace.Trace, None when not traced
        self.setup = setup  # {set-up step: seconds}
        self.launches = launches  # {kernel: launches a batch}
        self.facts = facts  # [BatchFacts] of a sample of served batches
        self.bench_dir = bench_dir
        self.notes = {}  # what a reader adds to the run's record

    def span_ms(self, name: str):
        """Mean ms a served batch spent in the client span `name`, None
        where no batch opened one."""
        t = [e - s for n, c, s, e in self.spans if n == name and c >= 0]
        if not t or not self.batches:
            return None
        return sum(t) / 1e6 / self.batches

    def busy_ms(self):
        """Device busy ms a batch, None when not traced."""
        if self.trace is None or not self.batches:
            return None
        return self.trace.busy_s * 1e3 / self.batches

    def roofline(self, kernel: str):
        """% of its roofline at which `kernel` (counts/<kernel>.py) ran
        over the window: the chip's least time for the window's batches
        (the sampled batches' mean times the batches served) over the
        kernel's device time. None where it did not run."""
        if self.trace is None or not self.facts:
            return None
        mod = manifest.load_count(kernel, self.bench_dir)
        t = self.trace.kernel_s(mod.KERNEL)
        if t <= 0:
            return None
        least, by = 0.0, {}
        scale = self.batches / len(self.facts)
        for facts in self.facts:
            s, b = peaks.least_seconds(*mod.count(facts), mod.ARITH)
            least += scale * s
            by[b] = by.get(b, 0.0) + s
        self.notes[kernel] = {"bound_by": max(by, key=by.get),
                              "least_s": least, "kernel_s": t,
                              "arith": mod.ARITH}
        return 100.0 * least / t

