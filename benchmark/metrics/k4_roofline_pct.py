"""% of its roofline at which K4 ran over the window (counts/k4.py)."""


def read(run):
    return run.roofline("k4")
