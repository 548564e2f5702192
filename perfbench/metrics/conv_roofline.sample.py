"""``conv_roofline.sample``: ``perfbench.layers.conv_roofline`` over the traced window of a
sample cell."""

from perfbench.layers import conv_roofline


def read(tv):
    return conv_roofline(tv, "sample")
