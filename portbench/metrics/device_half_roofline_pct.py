"""device_half_roofline_pct.<suffix> (%; device trace; the kernels): the
least time the card needs for the device half's contract bytes of the
window at its published memory bandwidth (roofline.py: each real input
byte read once, each output byte written once, padded rows not counted),
as a share of the union of the window's kernel intervals."""

from portbench.roofline import roofline_pct


def read(run):
    if not run.device or not run.rec:
        return None
    work = sum(b for _, _, b in run.rec.batches)
    return roofline_pct(work, run.device["kernel_busy_s"], run.kind)
