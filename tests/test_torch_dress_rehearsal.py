"""The port's command-line chain over a reference-layout directory, in the
order a reference user runs it (tests/test_dress_rehearsal.py's, with
``python -m cmhse_tpu_torch.cli.<name> --platform cpu``)::

    build_vocab -> train (word2vec .bin, 2 epochs) -> evaluate --dump_ranks
    -> import_torch (replica .pth.tar) -> evaluate -> export_torch
    -> retrieve

The imported replica is also run through the JAX package's commands: the
two ``--dump_ranks`` files agree line for line.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from torch_replica import TorchCMHSE

from cmhse_tpu_torch.cli.build_vocab import main as vocab_main
from cmhse_tpu_torch.cli.evaluate import main as eval_main
from cmhse_tpu_torch.cli.export_torch import main as export_main
from cmhse_tpu_torch.cli.import_torch import main as import_main
from cmhse_tpu_torch.cli.retrieve import main as retrieve_main
from cmhse_tpu_torch.cli.train import main as train_main
from cmhse_tpu_torch.data import Vocabulary
from cmhse_tpu_torch.data.fixtures import (make_sentence,
                                           write_reference_dataset,
                                           write_word2vec_bin)

torch.set_num_threads(2)

# hidden == embed: no joint projection, as shape inference expects of the
# replica checkpoint
FEAT, WORD_DIM, HIDDEN, EMBED = 8, 5, 16, 16
N_VAL = 8
CPU = ["--platform", "cpu"]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rsum(text):
    return float([ln for ln in text.splitlines()
                  if ln.startswith("rsum")][0].split(":")[1])


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("refdata"))
    write_reference_dataset(root, n_train=12, n_val=N_VAL, feat_dim=FEAT)
    return root


def test_cli_chain(data_dir, tmp_path, capsys, monkeypatch):
    # ---- build_vocab, json and the reference's pickle -------------------
    assert vocab_main(["--data_path", data_dir, "--threshold", "1",
                       *CPU]) == 0
    vocab = Vocabulary.load(os.path.join(data_dir, "vocab.json"))
    assert len(vocab) > 10 and vocab("man") != vocab(Vocabulary.UNK)
    pkl = str(tmp_path / "vocab.pkl")
    assert vocab_main(["--data_path", data_dir, "--threshold", "1", "--out",
                       pkl, *CPU]) == 0
    assert Vocabulary.load(pkl).word2idx == vocab.word2idx

    # ---- train, word2vec-initialized -------------------------------------
    w2v = os.path.join(data_dir, "vectors.bin")
    write_word2vec_bin(w2v, ["man", "runs", "park", "dog", "woman"],
                       dim=WORD_DIM)
    run = str(tmp_path / "run")
    capsys.readouterr()
    assert train_main([
        "--preset", "hier_anet", *CPU, "--data_path", data_dir,
        "--word2vec_path", w2v, "--vocab_size", str(len(vocab)),
        "--feat_dim", str(FEAT), "--word_dim", str(WORD_DIM),
        "--rnn_hidden", str(HIDDEN), "--embed_size", str(EMBED),
        "--max_clips", "3", "--max_frames", "6", "--max_sentences", "3",
        "--max_words", "12", "--batch_size", "8", "--num_epochs", "2",
        "--log_step", "1", "--snapshot_step", "1", "--logger_name", run,
    ]) == 0
    out = capsys.readouterr().out
    assert "word2vec init: 5/" in out
    assert "Video to Paragraph" in out and "done; best rsum" in out
    kinds = {e["event"] for e in _jsonl(os.path.join(run, "log.jsonl"))}
    assert {"word2vec_init", "train_step", "epoch_end", "validate",
            "snapshot"} <= kinds
    assert os.path.exists(os.path.join(run, "config.json"))
    assert os.path.exists(os.path.join(run, "best"))

    # ---- evaluate: dense, then streaming with a profiler trace ----------
    ranks = str(tmp_path / "ranks.jsonl")
    assert eval_main([run, *CPU, "--split", "val", "--dump_ranks",
                      ranks]) == 0
    plain = capsys.readouterr().out
    assert "Paragraph to Video" in plain and "rsum" in plain
    rows = _jsonl(ranks)
    assert [r["key"] for r in rows] == [f"v_val{i:03d}" for i in range(N_VAL)]
    assert [r["index"] for r in rows] == list(range(N_VAL))
    assert all(1 <= r["v2p_rank"] <= N_VAL and 1 <= r["p2v_rank"] <= N_VAL
               for r in rows)
    prof = str(tmp_path / "prof")
    ranks_s = str(tmp_path / "ranks_streaming.jsonl")
    assert eval_main([run, *CPU, "--streaming", "--profile_dir", prof,
                      "--dump_ranks", ranks_s]) == 0
    assert _rsum(capsys.readouterr().out) == _rsum(plain)
    assert _jsonl(ranks_s) == rows
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0

    # ---- import a reference .pth.tar; the JAX commands on the same file --
    torch.manual_seed(0)
    tm = TorchCMHSE(len(vocab), WORD_DIM, FEAT, HIDDEN, EMBED,
                    hierarchical=True)
    pth = str(tmp_path / "model_best.pth.tar")
    torch.save({"model": tm.state_dict(), "epoch": 3, "best_rsum": 1.0}, pth)
    imported = str(tmp_path / "imported")
    assert import_main([pth, imported, *CPU]) == 0
    ranks_imp = str(tmp_path / "ranks_imported.jsonl")
    assert eval_main([imported, "--data_path", data_dir, *CPU,
                      "--dump_ranks", ranks_imp]) == 0
    imp_out = capsys.readouterr().out
    assert "rsum" in imp_out

    from cmhse_tpu.cli.evaluate import main as jax_eval_main
    from cmhse_tpu.cli.import_torch import main as jax_import_main

    jax_imported = str(tmp_path / "jax_imported")
    assert jax_import_main([pth, jax_imported, "--platform", "cpu"]) == 0
    ranks_jax = str(tmp_path / "ranks_jax.jsonl")
    assert jax_eval_main([jax_imported, "--data_path", data_dir,
                          "--platform", "cpu", "--dump_ranks",
                          ranks_jax]) == 0
    jax_out = capsys.readouterr().out
    assert _jsonl(ranks_imp) == _jsonl(ranks_jax)
    assert _rsum(imp_out) == _rsum(jax_out)

    # ---- export the trained run back to torch ---------------------------
    back = str(tmp_path / "back_to_torch.pth.tar")
    assert export_main([run, back, *CPU]) == 0
    capsys.readouterr()
    sd = torch.load(back, map_location="cpu", weights_only=True)["model"]
    tm_back = TorchCMHSE(len(vocab), WORD_DIM, FEAT, HIDDEN, EMBED,
                         hierarchical=True)
    missing, unexpected = tm_back.load_state_dict(sd)
    assert not missing and not unexpected

    # ---- retrieve -------------------------------------------------------
    query = make_sentence(np.random.RandomState(3))
    assert retrieve_main([run, *CPU, "--query", query, "-k", "3"]) == 0
    ret = capsys.readouterr().out
    assert f"query: {query!r}" in ret
    hits = [ln for ln in ret.splitlines() if ln.strip().startswith("1.")]
    assert hits and "v_val" in hits[0]
    assert ret.count("score=") == 3
    # an oversized k clamps to the valid gallery
    assert retrieve_main([run, *CPU, "--query", query, "-k", "99"]) == 0
    big = capsys.readouterr().out
    assert big.count("score=") == N_VAL and "-inf" not in big
    # both directions from one encode
    assert retrieve_main([run, *CPU, "--query", query, "--query_video",
                          "v_val000", "-k", "2"]) == 0
    both = capsys.readouterr().out
    assert f"query: {query!r}" in both
    assert "video query: 'v_val000' (paragraphs)" in both
    assert both.count("score=") == 4
    assert [ln for ln in both.splitlines()
            if ln.strip().startswith("1.")][0] == hits[0]
    with pytest.raises(SystemExit, match="not in the val split"):
        retrieve_main([run, *CPU, "--query_video", "v_nope", "-k", "3"])
    q2 = make_sentence(np.random.RandomState(9))
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{query}\n\n{q2}\n"))
    assert retrieve_main([run, *CPU, "--interactive", "-k", "2"]) == 0
    inter = capsys.readouterr().out
    assert inter.count("query:") == 2 and inter.count("score=") == 4
