"""``glue_ms_per_slice.train``: ``perfbench.layers.glue_ms_per_slice`` over the traced window of a
train cell."""

from perfbench.layers import glue_ms_per_slice


def read(tv):
    return glue_ms_per_slice(tv, "train")
