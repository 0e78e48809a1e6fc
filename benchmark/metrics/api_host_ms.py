"""Host ms a batch of the API (`api.py::batch_search`, `_raw_batch_search`:
padding, planning, copies, result lists): the benchmark's span around
`batch_search`, less the device's busy ms a batch."""


def read(run):
    span, busy = run.span_ms("batch_search"), run.busy_ms()
    if span is None or busy is None:
        return None
    return span - busy
