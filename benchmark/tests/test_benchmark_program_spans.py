"""The readers of the program's own spans (``rows_ms.train``,
``pack_ms.train``, ``pin_ms.train``) by hand, idle time put under a program
span inside a harness span, and a ``--trace 0`` run leaving the program's
recorder off."""

import pytest
import torch

import run
from conftest import toy_sizes
from harness import common, program_spans
from harness.trace import Spans, TraceReading
from test_benchmark_traffic import _Event

from cmhse_tpu_torch.utils import timing


def _span(name, start, end, id, parent=None, key=0):
    return timing.SpanRecord(name, start, end, key, 1, id, parent)


@pytest.fixture
def window(monkeypatch):
    """A hand-made recording of two batches in place of the program's
    ``timing.profiled``."""
    rec = timing.Recording()
    rec.spans += [
        _span("loader.rows", 0, 2_000_000, 1),
        _span("native.pack", 2_000_000, 7_000_000, 2),
        _span("prefetch.slot_wait", 7_000_000, 8_000_000, 4, parent=3),
        _span("prefetch.pin", 7_000_000, 19_000_000, 3),
        _span("loader.rows", 30_000_000, 34_000_000, 5, key=1),
        _span("native.pack", 34_000_000, 41_000_000, 6, key=1),
        _span("prefetch.pin", 41_000_000, 50_000_000, 7, key=1),
        _span("step.forward", 50_000_000, 60_000_000, 8)]
    monkeypatch.setattr(timing, "profiled", rec)
    return rec


def _read(name):
    return common.metric_reader(name)(run.Measurements({}))


def test_readers_by_hand(window):
    assert _read("rows_ms.train") == pytest.approx((2 + 4) / 2)
    assert _read("pack_ms.train") == pytest.approx((5 + 7) / 2)
    # 12 ms less a 1 ms slot wait, and 9 ms
    assert _read("pin_ms.train") == pytest.approx((11 + 9) / 2)


def test_readers_read_nothing_without_the_programs_records(monkeypatch):
    monkeypatch.setattr(timing, "profiled", timing.Recording())
    for name in ("rows_ms.train", "pack_ms.train", "pin_ms.train"):
        assert _read(name) is None
    monkeypatch.delattr(timing, "profiled")  # a program without the recorder
    for name in ("rows_ms.train", "pack_ms.train", "pin_ms.train"):
        assert _read(name) is None


def test_idle_inside_batch_wait_goes_to_the_program_span():
    """A window of 100 ns, busy only at its ends: of the idle 80 ns inside
    ``batch_wait``, the 30 ns a ``native.pack`` span covers go to it and
    the rest stays under ``batch_wait``."""
    spans = Spans()
    spans.items += [("batch_wait", 1000, 1100)]
    rec = timing.Recording()
    rec.spans += [_span("native.pack", 1040, 1070, 1),
                  _span("loader.rows", 5000, 5010, 2)]  # past the window
    events = [_Event("cuda_runtime", "cudaDeviceSynchronize", 100, 0),
              _Event("kernel", "k", 100, 10),
              _Event("kernel", "k", 190, 10),
              _Event("cuda_runtime", "cudaDeviceSynchronize", 200, 0)]
    t = TraceReading(events, marker_ns=1000, spans=spans)
    spans.items += program_spans.triples(rec, 1000, 1100)
    assert dict(t.idle_gaps()) == pytest.approx({"batch_wait": 50e-9,
                                                 "native.pack": 30e-9})


def test_trace_0_run_leaves_the_recorder_off():
    """A ``--trace 0`` run at toy sizes on the CPU: the program's recorder
    is off at every step, and records nothing."""
    from cmhse_tpu_torch.train import loop

    seen = []

    def step(state, batch, loss_cfg):
        seen.append(timing.active())
        return loop.train_step(state, batch, loss_cfg)

    timing.profiled.clear()
    cell = "didemo.train"
    res = run.run_cell(cell, 2**31 + 5, 0.5, False, torch.device("cpu"),
                       hooks={"train_step": step},
                       sizes=toy_sizes(common.load_json("cells", cell)))
    assert res["correct"] and seen and not any(seen)
    assert timing.profiled.spans == [] and timing.profiled.counters == {}
