"""The port's bench entry (``cmhse_tpu_torch.cli.bench``) on the CPU at
toy sizes, as ``tests/test_bench_harness.py`` runs the JAX bench: the
top-k variants and the standalone top-k give finite queries/s, the
analytic FLOPs equal the JAX bench's, and ``main`` prints exactly one JSON
line: a null value and the error without a card, every metric finite with
``--platform cpu``. Full-size numbers come from the card only."""

import json
import math
import os
import sys

import pytest
import torch

from cmhse_tpu_torch.cli import bench

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jax_bench  # noqa: E402  (the repo-root JAX bench)

torch.set_num_threads(2)
CPU = torch.device("cpu")
# golden widths (tests/make_goldens.py), small galleries
TOY = bench.Shapes(batch=4, max_clips=2, max_frames=5, max_sentences=2,
                   max_words=4, feat_dim=12, embed=32, hidden=32,
                   word_dim=16, vocab=64, train_batch=4, gallery=96,
                   query_block=8, rows_100k=512, queries_100k=8, k=3,
                   standalone_reps=2)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def test_topk_bench_variants_produce_finite_qps():
    out = bench.bench_topk_100k(CPU, TOY)
    assert set(out) == {"stream", "stream_prepared", "dense"}
    assert all(_finite(v) for v in out.values()), out


def test_topk_standalone_bench_produces_finite_qps():
    qps, ms = bench.bench_topk_standalone(CPU, TOY)
    assert set(qps) == set(ms) == {"stream_prepared"}
    assert _finite(qps["stream_prepared"]) and _finite(ms["stream_prepared"])


def test_rank_count_and_sim_benches_produce_finite_qps():
    ranks = bench.bench_rank_counts_100k(CPU, TOY)
    assert set(ranks) == {"stream_f32", "stream_bf16mult", "dense_bf16mult",
                          "dense_f32"}
    assert all(_finite(v) for v in ranks.values()), ranks
    assert _finite(bench.bench_sim_qps(CPU, TOY))


def test_analytic_flops_equal_the_jax_bench():
    f = bench.analytic_encode_flops_per_pair()
    assert f > 1e9  # a multi-GFLOP model: guards a unit slip
    assert f == jax_bench.analytic_encode_flops_per_pair()
    for name in ("BATCH", "MAX_CLIPS", "MAX_FRAMES", "MAX_SENTENCES",
                 "MAX_WORDS", "FEAT_DIM", "EMBED", "HIDDEN", "WORD_DIM",
                 "VOCAB", "GALLERY", "QUERY_BLOCK"):
        field = name.lower()
        assert getattr(bench.HEADLINE, field) == getattr(jax_bench, name)
    assert bench.EST_REF_PAIRS_PER_SEC == jax_bench.EST_REF_PAIRS_PER_SEC


def test_main_without_a_card_prints_one_null_json_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    back = json.loads(lines[0])
    assert back["value"] is None and back["vs_baseline"] is None
    assert "no CUDA device" in back["extras"]["error"]


def test_main_on_the_cpu_reports_every_metric(monkeypatch, capsys):
    """``--platform cpu`` at toy sizes: one JSON line, every metric the
    JAX bench reports finite (the MFU is the card's only), the encode and
    train steps through the plain versions (no kernel launches)."""
    monkeypatch.setattr(bench, "HEADLINE", TOY)
    assert bench.main(["--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    back = json.loads(lines[0])
    ex = back["extras"]
    assert _finite(back["value"]) and _finite(back["vs_baseline"])
    for key in ("sim_matrix_qps_10k_gallery", "train_pairs_per_sec"):
        assert _finite(ex[key]), key
    flops = bench.analytic_encode_flops_per_pair(TOY)
    assert ex["model_gflops_per_pair"] == round(flops / 1e9, 2)
    # toy sizes round the rate to 0 TFLOP/s: held to its definition
    assert ex["achieved_tflops_per_sec"] == round(
        back["value"] * flops / 1e12, 2)
    for group in ("rank_qps_100k", "topk_qps_100k",
                  "topk_standalone_qps_100k", "topk_standalone_ms_100k"):
        assert ex[group] and all(_finite(v) for v in ex[group].values())
    assert ex["platform"] == "cpu" and ex["mfu"] is None
    assert ex["launches"] == {}
