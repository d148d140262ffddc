"""Host batch making, pinned staging: the mean self milliseconds of the
program's ``prefetch.pin`` span a batch in the traced window (the copy
into the pinned slot, ``data/prefetch.py``), less its
``prefetch.slot_wait`` for the slot's last copy."""

from harness import program_spans


def read(m):
    rec = program_spans.window()
    return None if rec is None else \
        program_spans.mean_self_ms(rec, "prefetch.pin")
