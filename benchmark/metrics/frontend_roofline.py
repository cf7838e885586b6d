"""The RF front-end's share of its roofline, in %: the stage's required
work (``roofline.frontend_work``: the u8 input read once, I and Q at the
IF rate written once, 2 operations per tap and output) as bound time on
the published H100 peaks, over the device time of the kernels that
``frontend_roofline.json`` lists for the stage."""

from harness import roofline


def read(t):
    s = t.kernel_s(t.data("frontend_roofline"))
    if not s:
        return None
    nbytes, ops = roofline.frontend_work(t.cfg, t.mix["channels"], t.blocks)
    return 100.0 * roofline.bound_s(nbytes, ops)[0] / s
