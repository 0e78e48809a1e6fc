"""% of its roofline at which K3 ran over the window (counts/k3.py)."""


def read(run):
    return run.roofline("k3")
