"""Host ms a batch in `plan_caps` (`search/grouped.py::plan_caps`, the C++
planner of `native/planner.cpp`), from the benchmark's span around the
call."""


def read(run):
    return run.span_ms("plan_caps")
