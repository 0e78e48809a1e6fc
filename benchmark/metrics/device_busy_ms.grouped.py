"""Device busy ms a batch of the grouped program (`search/grouped.py`:
`derive_plan_device`, `_grouped_impl`, the copies)."""


def read(run):
    return run.busy_ms() if run.program == "grouped" else None
