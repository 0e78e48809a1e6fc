"""Seconds of the index's upload to the card (`types.py::IndexArrays.
to_device`, through `device_index()` in the API), from the benchmark's
span around the call."""


def read(run):
    return run.setup.get("upload")
