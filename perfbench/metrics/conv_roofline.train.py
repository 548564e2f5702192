"""``conv_roofline.train``: ``perfbench.layers.conv_roofline`` over the traced window of a
train cell."""

from perfbench.layers import conv_roofline


def read(tv):
    return conv_roofline(tv, "train")
