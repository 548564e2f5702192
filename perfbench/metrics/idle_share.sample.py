"""``idle_share.sample``: ``perfbench.layers.idle_share`` over the traced window of a
sample cell."""

from perfbench.layers import idle_share


def read(tv):
    return idle_share(tv, "sample")
