"""Host batch making left exposed: the mean milliseconds a step waits on
the prefetch iterator's ``next`` (the loader, the native packer, the
pinned ring)."""


def read(m):
    waits = m.spans.of("batch_wait")
    if not waits:
        return None
    return sum(b - a for a, b in waits) / len(waits) / 1e6
