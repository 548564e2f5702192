"""``idle_share.train``: ``perfbench.layers.idle_share`` over the traced window of a
train cell."""

from perfbench.layers import idle_share


def read(tv):
    return idle_share(tv, "train")
