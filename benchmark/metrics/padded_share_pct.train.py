"""Padding the buckets leave: padded frame- and word-steps that carry no
data, over all padded frame- and word-steps of the window's batches."""

from harness import counts


def read(m):
    if not m.log["lengths"]:
        return None
    total = live = 0
    for s in m.log["lengths"]:
        t, lv = counts.padded_steps(s)
        total += t
        live += lv
    return 100.0 * (total - live) / total
