"""The port's span recorder (``cmhse_tpu_torch.utils.timing``): off by
default, spans nested and keyed, stamps on ``time.time_ns``, counters from
several threads; the spans of the batch pipeline and the train step on the
CPU, a packer build counted, and ``profiler_trace`` writing the spans
beside its Chrome trace."""

import json
import sys
import threading
import time

import pytest
import torch

from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig, LossConfig,
                                    ModelConfig, TrainConfig)
from cmhse_tpu_torch.utils import timing

torch.set_num_threads(2)


def test_recorder_is_off_by_default_and_records_nothing():
    assert not timing.active()
    before = len(timing.profiled.spans)
    site = timing.span("loader.rows", key=3)
    assert site is timing.span("native.pack")  # one shared no-op context
    with site:
        timing.count("loader.rows", 5)
    assert timing.next_key() is None and timing.current_key() is None
    assert len(timing.profiled.spans) == before
    assert "loader.rows" not in timing.profiled.counters


def test_spans_nest_with_parents_and_share_a_key():
    with timing.recording() as rec:
        assert timing.active()
        key = timing.next_key()
        with timing.span("prefetch.pin"):
            with timing.span("prefetch.slot_wait"):
                pass
        with timing.span("other", key=key + 100):
            pass
    assert not timing.active()
    wait, pin, other = rec.spans
    assert (wait.name, pin.name, other.name) == (
        "prefetch.slot_wait", "prefetch.pin", "other")
    assert wait.parent == pin.id and pin.parent is None
    assert wait.key == pin.key == key and other.key == key + 100
    assert wait.thread == pin.thread == threading.get_native_id()
    assert pin.start_ns <= wait.start_ns <= wait.end_ns <= pin.end_ns


def test_stamps_lie_between_host_clock_reads():
    with timing.recording() as rec:
        t0 = time.time_ns()
        with timing.span("a"):
            time.sleep(0.002)
        t1 = time.time_ns()
    (a,) = rec.spans
    assert t0 <= a.start_ns and a.end_ns <= t1
    assert a.end_ns - a.start_ns >= 2_000_000


def test_counters_add_from_many_threads():
    n_threads, adds = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timing.recording() as rec:
            def work():
                for _ in range(adds):
                    timing.count("prefetch.bytes", 3)
                    with timing.span("t"):
                        pass
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert rec.counters["prefetch.bytes"] == 3 * adds * n_threads
    assert len(rec.of("t")) == adds * n_threads
    assert all(s.parent is None for s in rec.spans)


def test_profiler_session_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    timing.profiled.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.active()
        with timing.span("inside"):
            pass
    with timing.span("after"):
        pass
    assert [s.name for s in timing.profiled.spans] == ["inside"]
    timing.profiled.clear()


def _toy_config():
    data = DataConfig(batch_size=4, feat_dim=20, vocab_size=64, max_clips=3,
                      max_frames=6, max_sentences=3, max_words=5)
    model = ModelConfig(embed_size=32, word_dim=16, feat_dim=20,
                        rnn_hidden=32, hierarchical=True)
    return ExperimentConfig(data=data, model=model,
                            loss=LossConfig(recon_weight=0.0),
                            train=TrainConfig(lr=1e-3))


def test_pipeline_and_step_spans_share_each_batch_key():
    """batches_from_dataset -> Prefetcher("cpu") -> train_step at toy
    sizes: per batch, the loader's and the packer's spans, then the four
    step spans, in that order and under one key; counters of rows and
    packed bytes."""
    from cmhse_tpu_torch.data import (Prefetcher, SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.native import library
    from cmhse_tpu_torch.train import create_train_state, train_step

    cfg = _toy_config()
    library()  # built and loaded outside the recording
    ds = SyntheticHierarchicalDataset(num_videos=10, feat_dim=20,
                                      vocab_size=64, max_clips=3,
                                      max_frames=6, max_words=5, seed=3)
    with timing.recording() as rec:
        state = create_train_state(cfg, CMHSE(cfg.model, 64, device="cpu"))
        batches = batches_from_dataset(ds, cfg.data, shuffle=True, seed=1)
        nbytes = 0
        for host, batch in Prefetcher("cpu")(batches):
            nbytes += sum(v.nbytes for v in vars(host).values())
            state, _ = train_step(state, batch, cfg.loss)
    names = [s.name for s in rec.spans]
    assert names[:2] == ["model.init", "state.init"]
    per_batch = ["loader.rows", "native.pack", "step.forward", "step.loss",
                 "step.backward", "step.update"]
    assert names[2:] == per_batch * 3
    keys = [s.key for s in rec.spans[2:]]
    for k in range(3):
        assert len(set(keys[6 * k:6 * k + 6])) == 1
    assert len(set(keys)) == 3 and None not in keys
    starts = [s.start_ns for s in rec.spans[2:]]
    assert starts == sorted(starts)
    assert rec.counters["loader.rows"] == 10
    assert rec.counters["native.bytes"] == nbytes


def test_packer_build_counts_once(tmp_path, monkeypatch):
    """A build into an empty build root is one compile; loading it again
    compiles nothing."""
    from cmhse_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    with timing.recording() as rec:
        native.build()
        native.build()
    assert rec.counters["builds"] == 1
    assert [s.name for s in rec.spans] == ["native.build"]
    native.library.cache_clear()
    try:
        with timing.recording() as rec:
            native.library()
        assert "builds" not in rec.counters
        (load,) = rec.of("native.load")
        assert load.end_ns > load.start_ns
    finally:
        native.library.cache_clear()


@pytest.mark.parametrize("region_spans", [1, 3])
def test_profiler_trace_writes_spans_in_the_trace_timebase(tmp_path,
                                                           region_spans):
    """``profiler_trace`` writes ``spans.json`` beside ``trace.json``:
    every span of the region, its counters, and times on the Chrome trace's
    own base, so that a span around an operator encloses the operator's
    event in ``trace.json``."""
    logdir = tmp_path / "trace"
    with timing.profiler_trace(str(logdir)):
        a = torch.ones(64, 64)
        for i in range(region_spans):
            with timing.span("around", key=i):
                time.sleep(0.001)
                a.matmul(a)
                time.sleep(0.001)
        timing.count("rows", 2)
    assert not timing.active()
    trace = json.loads((logdir / "trace.json").read_text())
    spans = json.loads((logdir / "spans.json").read_text())
    assert spans["counters"] == {"rows": 2}
    assert spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    around = [e for e in spans["traceEvents"] if e["name"] == "around"]
    assert [e["args"]["key"] for e in around] == list(range(region_spans))
    ops = sorted((e for e in trace["traceEvents"]
                  if e.get("name") == "aten::matmul"), key=lambda e: e["ts"])
    assert len(ops) == region_spans
    for span, op in zip(around, ops):
        # 1 ms apart on either side: a join good to well under that
        assert span["ts"] + 500 <= op["ts"]
        assert op["ts"] + op["dur"] + 500 <= span["ts"] + span["dur"]


def test_train_command_profile_dir_writes_the_spans(tmp_path):
    """``cli.train --profile_dir`` on the CPU at toy sizes: ``spans.json``
    beside ``trace.json`` holds the run's set-up, batch and step spans and
    its counters."""
    from cmhse_tpu_torch.cli.train import main as train_main

    prof = tmp_path / "prof"
    assert train_main([
        "--preset", "hier_anet", "--platform", "cpu", "--synthetic",
        "--synthetic_videos", "16", "--batch_size", "8", "--num_epochs", "1",
        "--feat_dim", "20", "--embed_size", "32", "--rnn_hidden", "32",
        "--word_dim", "16", "--vocab_size", "64", "--max_clips", "3",
        "--max_frames", "6", "--max_sentences", "3", "--max_words", "5",
        "--logger_name", str(tmp_path / "run"), "--profile_dir", str(prof),
    ]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    spans = json.loads((prof / "spans.json").read_text())
    names = {e["name"] for e in spans["traceEvents"]}
    assert {"model.init", "state.init", "loader.rows", "native.pack",
            "step.forward", "step.loss", "step.backward",
            "step.update"} <= names
    assert spans["counters"]["loader.rows"] >= 16
