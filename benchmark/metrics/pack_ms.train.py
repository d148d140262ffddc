"""Host batch making, the native packer: the mean milliseconds of the
program's ``native.pack`` span a batch in the traced window (the zeroed
outputs, the row tables and both native calls, ``native/``)."""

from harness import program_spans


def read(m):
    rec = program_spans.window()
    return None if rec is None else program_spans.mean_ms(rec, "native.pack")
