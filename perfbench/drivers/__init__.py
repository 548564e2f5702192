"""One driver a kind of traffic: sample (serving), train."""
