"""% of its roofline at which K7 ran over the window (counts/k7.py)."""


def read(run):
    return run.roofline("k7")
