"""``mfu.sample``: ``perfbench.layers.mfu`` over the traced window of a
sample cell."""

from perfbench.layers import mfu


def read(tv):
    return mfu(tv, "sample")
