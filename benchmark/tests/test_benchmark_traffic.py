"""The traffic generator, the yardstick's arithmetic, and the harness
finding its files (cells, configurations, mixes, generators, runners,
metric readers) by name."""

import json

import numpy as np
import pytest

from harness import common, counts


def _mix(name):
    return common.load_json("traffic", name)


def _split(mix, *args, **kwargs):
    return common.generator(mix).split(mix, *args, **kwargs)


def test_seed_reproduces_training_split():
    a = _split(_mix("anet_train"), 2**31 + 3, 4, 100, n_videos=50)
    b = _split(_mix("anet_train"), 2**31 + 3, 4, 100, n_videos=50)
    assert np.array_equal(a.features, b.features)
    assert np.array_equal(a.tokens, b.tokens)
    assert np.array_equal(a.frames, b.frames)
    c = _split(_mix("anet_train"), 5, 4, 100, n_videos=50)
    assert not np.array_equal(a.frames, c.frames)


def test_anet_means_match_published_statistics():
    split = _split(_mix("anet_train"), 1, 2, 10000)
    assert len(split) == 10009
    clips = np.diff(split.clip_off)
    assert abs(clips.mean() - 3.65) <= 0.1 * 3.65
    assert abs(split.words.mean() - 13.5) <= 0.1 * 13.5
    assert clips.min() >= 1 and clips.max() <= 8
    assert split.frames.min() >= 4 and split.frames.max() <= 64


def test_didemo_fills_every_bucket_in_an_epoch():
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data.loader import batches_from_dataset

    cfg = get_preset("didemo").data
    split = _split(_mix("didemo_train"), 4, 2, 10000)
    assert len(split) == 8395
    import dataclasses
    cfg = dataclasses.replace(cfg, feat_dim=2)
    seen = {(b.frames.shape[2], b.words.shape[2])
            for b in batches_from_dataset(split, cfg, shuffle=True, seed=1,
                                          fixed_shape=False,
                                          group_by_length=True)}
    assert {f for f, _ in seen} == {12, 24, 48}
    assert {w for _, w in seen} == {8, 16, 32}
    assert abs(split.words.mean() - 8.0) <= 0.1 * 8.0
    clips = np.diff(split.clip_off)
    assert np.mean(clips >= 5) > 0.6 and clips.max() <= 6


def test_gru_bound_by_hand():
    # b=2 rows, t=3 steps, h=4, 5 live row-steps, forward, no gates
    flops = 2.0 * 5 * 4 * 12
    streams = 5 * 12 + 4 * 12 + 2 * 3 * 4 + 2 * 4
    nbytes = 4.0 * streams + 4.0 * (12 + 2)
    want = max(flops / 67e12, nbytes / 3.35e12)
    assert counts.gru_bound_s(2, 3, 4, 5) == pytest.approx(want, rel=1e-12)


def test_train_step_flops_by_hand():
    model = {"embed_size": 2, "rnn_hidden": 2, "word_dim": 3, "feat_dim": 5,
             "attention_pool": False, "hierarchical": True,
             "reconstruction": False}
    lengths = {"frame_len": np.array([[2, 0]]), "word_len": np.array([[1, 0]]),
               "clip_len": np.array([1]), "sent_len": np.array([1]),
               "valid": np.array([True]), "frames": 4, "words": 4}
    gru = lambda live, d: 2.0 * live * 6 * (d + 2)  # noqa: E731
    fwd = gru(2, 5) + gru(1, 2) + gru(1, 3) + gru(1, 2)
    fwd += 2.0 * 1 * 1 * 2 + 2.0 * 1 * 1 * 2  # the two 1 x 1 rankings
    assert counts.train_step_flops(lengths, model) == pytest.approx(3 * fwd)
    assert counts.padded_steps(lengths) == (16, 3)


def test_files_found_by_name(tmp_path):
    for kind in ("cells", "configs", "traffic", "metrics", "runners",
                 "generators"):
        (tmp_path / kind).mkdir()
    (tmp_path / "cells" / "new.cell.json").write_text(
        json.dumps({"kind": "train", "config": "c"}))
    (tmp_path / "configs" / "c.json").write_text(json.dumps({"name": "c"}))
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({"kind": "g"}))
    (tmp_path / "metrics" / "new_metric.train.py").write_text(
        "def read(m):\n    return 42.0\n")
    (tmp_path / "runners" / "r.py").write_text("def run(*a, **k):\n"
                                               "    return 'ran'\n")
    (tmp_path / "generators" / "g.py").write_text("def split(*a):\n"
                                                  "    return 'drawn'\n")
    assert common.load_json("cells", "new.cell", base=tmp_path)["config"] \
        == "c"
    assert common.load_json("configs", "c", base=tmp_path)["name"] == "c"
    mix = common.load_json("traffic", "t", base=tmp_path)
    assert common.generator(mix, base=tmp_path).split() == "drawn"
    assert common.metric_reader("new_metric.train", base=tmp_path)(None) \
        == 42.0
    assert common.runner("r", base=tmp_path)() == "ran"
    with pytest.raises(FileNotFoundError):
        common.runner("absent", base=tmp_path)
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
            "per_layer": [{"name": "m1", "moves": "a"},
                          {"name": "m2", "moves": "b"},
                          {"name": "m3", "moves": "a", "workloads": ["y"]}]}
    e2e, layer = common.cell_metrics(spec, "new.cell")
    assert [m["name"] for m in e2e] == ["a"]
    assert [m["name"] for m in layer] == ["m1"]


NEW_RUNNER = '''
from pathlib import Path
from harness import common

def run(cell, config, mix, seed, seconds, trace, device, t_process,
        hooks=None, sizes=None):
    gen = common.generator(mix, Path(__file__).resolve().parent.parent)
    due = gen.arrivals(mix, seed)
    return {"numbers": {"gap": 0.0}, "attempted": len(due), "failed": 0,
            "setup_s": 1.5, "served_per_s": len(due) / mix["seconds"],
            "due": due}
'''

NEW_GENERATOR = '''
import numpy as np

def arrivals(mix, seed):
    """On/off arrivals: ``burst`` at once every ``period`` seconds."""
    starts = np.arange(0.0, mix["seconds"], mix["period"])
    return np.repeat(starts, mix["burst"])
'''


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_kind_and_mix_are_taken_as_files(tmp_path, trace):
    """A cell of a new kind, on a mix with a new generator and a metric of
    its own, in a copy of the benchmark: only files are added, and
    ``run_cell`` runs it."""
    import shutil

    import run

    bench = tmp_path / "benchmark"
    shutil.copytree(common.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = common.benchmark_spec()
    before = {p.relative_to(common.BENCH_DIR): p.read_bytes()
              for p in common.BENCH_DIR.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts
              and "tests" not in p.parts}
    spec["workloads"].append({"name": "toy.burst", "config": "cmhse_full",
                              "traffic": "bursts", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "served_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy.burst"]})
    spec["per_layer"].append({"name": "burst_size.toy", "unit": "queries",
                              "better": "higher", "source": "host_clock",
                              "layer": "arrivals", "moves": "served_per_s",
                              "workloads": ["toy.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "runners" / "served.py").write_text(NEW_RUNNER)
    (bench / "generators" / "onoff.py").write_text(NEW_GENERATOR)
    (bench / "traffic" / "bursts.json").write_text(json.dumps(
        {"kind": "onoff", "seconds": 2.0, "period": 0.5, "burst": 4}))
    (bench / "cells" / "toy.burst.json").write_text(json.dumps(
        {"kind": "served", "config": "cmhse_full", "traffic": "bursts",
         "why": "t", "limits": {"gap": 0.0}}))
    (bench / "metrics" / "burst_size.toy.py").write_text(
        "def read(m):\n    return float(len(m.due)) / 4\n")
    res = run.run_cell("toy.burst", 1, 1.0, trace, None, root=tmp_path)
    assert res["correct"] and res["attempted"] == 16
    if trace:
        assert res["metrics"] == {"burst_size.toy": {"value": 4.0,
                                                      "unit": "queries"}}
    else:
        assert res["metrics"]["served_per_s"]["value"] == 8.0
        assert res["metrics"]["setup_s"]["value"] == 1.5
    after = {p: (common.BENCH_DIR / p).read_bytes() for p in before}
    assert after == before


def test_every_listed_metric_has_a_reader():
    spec = common.benchmark_spec()
    for m in spec["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    for w in spec["workloads"]:
        cell = common.load_json("cells", w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        common.load_json("configs", cell["config"])
        common.load_json("traffic", cell["traffic"])


class _Event:
    def __init__(self, kind, name, start, dur):
        self.kind, self._name, self.start, self.dur = kind, name, start, dur

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur


def test_trace_reading_by_hand():
    """Busy and idle time, kernel time by name and idle gaps by span, on a
    hand-made trace: a window of 100 ns between two synchronizations, two
    overlapping kernels and a copy."""
    from harness.trace import Spans, TraceReading

    spans = Spans()
    spans.items += [("batch_wait", 1040, 1070), ("train_step", 1000, 1040)]
    events = [_Event("cuda_runtime", "cudaDeviceSynchronize", 100, 0),
              _Event("kernel", "void gru_fwd_kernel<float>(x)", 110, 20),
              _Event("kernel", "cutlass::Kernel2<a>", 120, 30),
              _Event("gpu_memcpy", "Memcpy HtoD", 170, 10),
              _Event("cuda_runtime", "cudaDeviceSynchronize", 190, 10)]
    t = TraceReading(events, marker_ns=1000, spans=spans)
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(50e-9)
    assert t.kernel_seconds(r"gru_fwd(_streamed)?_kernel") == \
        pytest.approx(20e-9)
    assert dict(t.top_operations())["gru_fwd_kernel"] == pytest.approx(20e-9)
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"outside any span": 20e-9,
                                  "batch_wait": 20e-9, "train_step": 10e-9})
