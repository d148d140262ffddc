"""Host batch making, row gather: the mean milliseconds of the program's
``loader.rows`` span a batch in the traced window (``dataset[i]`` for the
batch's rows and the bucket choice, ``data/loader.py``)."""

from harness import program_spans


def read(m):
    rec = program_spans.window()
    return None if rec is None else program_spans.mean_ms(rec, "loader.rows")
