"""``mfu.train``: ``perfbench.layers.mfu`` over the traced window of a
train cell."""

from perfbench.layers import mfu


def read(tv):
    return mfu(tv, "train")
