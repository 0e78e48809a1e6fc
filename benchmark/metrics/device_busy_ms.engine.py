"""Device busy ms a batch of the engine program (`search/engine.py::
_search_impl`, the copies)."""


def read(run):
    return run.busy_ms() if run.program == "engine" else None
