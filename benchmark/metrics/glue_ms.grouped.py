"""Device ms a batch of the grouped program's glue: the kernels that are
not the program's own (PyTorch's sorts, scans, gathers, top-k,
elementwise), copies and sets left out."""


def _glue(trace, name):
    return not (trace.is_own(name) or name.startswith(("Memcpy", "Memset")))


def read(run):
    if run.program != "grouped" or run.trace is None or not run.batches:
        return None
    t = run.trace.seconds(lambda n: _glue(run.trace, n))
    return 1e3 * t / run.batches if t > 0 else None
