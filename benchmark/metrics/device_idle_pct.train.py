"""Share of the traced window in which no kernel, copy or memset ran on
the card (training cells)."""


def read(m):
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
