"""The port's command-line surface (``cmhse_tpu_torch.cli``): the JAX
package's flag tests (tests/test_cli.py) through the port's
``apply_overrides``; every option of the JAX commands present in the port's
parser or named as JAX-only or later; each command refusing to start
without a card unless ``--platform cpu`` is passed."""

import argparse
import dataclasses
import importlib
import json

import pytest
import torch

from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
from cmhse_tpu_torch.cli.train import apply_overrides, build_parser
from cmhse_tpu_torch.config import ExperimentConfig, get_preset

torch.set_num_threads(2)

COMMANDS = ("build_vocab", "train", "evaluate", "import_torch",
            "export_torch", "retrieve", "serve_daemon")


def _cfg(argv):
    args = build_parser().parse_args(argv)
    return apply_overrides(get_preset(args.preset), args)


def test_defaults_pass_through():
    cfg = _cfg(["--preset", "hier_anet"])
    assert cfg.model.hierarchical is True
    assert cfg.loss.margin == 0.2
    assert cfg.loss.max_violation is True
    assert cfg == get_preset("hier_anet")


def test_reference_flags_map():
    cfg = _cfg([
        "--preset", "hier_anet", "--margin", "0.3", "--embed_size", "512",
        "--word_dim", "200", "--num_epochs", "7", "--batch_size", "16",
        "--lr", "2e-4", "--lr_update", "10", "--grad_clip", "1.5",
        "--logger_name", "/tmp/xyz", "--data_path", "/data/anet",
        "--data_name", "anet_precomp", "--feat_dim", "2048",
        "--word2vec_path", "/data/vec.npz", "--steps_per_dispatch", "2",
        "--snapshot_step", "4", "--val_step", "0",
    ])
    assert cfg.data.word2vec_path == "/data/vec.npz"
    assert cfg.loss.margin == 0.3
    assert cfg.model.embed_size == 512
    assert cfg.model.word_dim == 200
    assert cfg.train.num_epochs == 7
    assert cfg.data.batch_size == 16
    assert cfg.train.lr == 2e-4
    assert cfg.train.lr_update == 10
    assert cfg.train.grad_clip == 1.5
    assert cfg.train.checkpoint_dir == "/tmp/xyz"
    assert cfg.data.data_path == "/data/anet"
    assert cfg.data.dataset == "anet_precomp"
    assert cfg.data.feat_dim == 2048 and cfg.model.feat_dim == 2048
    assert cfg.train.steps_per_dispatch == 2
    assert cfg.train.snapshot_step == 4 and cfg.train.val_step == 0
    assert _cfg(["--learning_rate", "3e-4"]).train.lr == 3e-4


def test_flat_and_loss_structure_flags():
    cfg = _cfg(["--preset", "hier_anet", "--flat", "--no_max_violation",
                "--low_weight", "0.0", "--recon_weight", "0.001"])
    assert cfg.model.hierarchical is False
    assert cfg.data.max_clips == 1 and cfg.data.max_sentences == 1
    assert cfg.loss.max_violation is False
    assert cfg.loss.low_weight == 0.0
    assert cfg.loss.recon_weight == 0.001


@pytest.mark.parametrize("argv,field,want", [
    ([], ("loss", "max_violation"), True),
    (["--max_violation"], ("loss", "max_violation"), True),
    (["--no_max_violation"], ("loss", "max_violation"), False),
    ([], ("data", "fixed_shape"), True),
    (["--bucketed"], ("data", "fixed_shape"), False),
    (["--bucketed"], ("data", "group_by_length"), True),
    (["--fixed_shape"], ("data", "group_by_length"), False),
    (["--attention_pool"], ("model", "attention_pool"), True),
    ([], ("model", "attention_pool"), False),
])
def test_tristate_flags(argv, field, want):
    cfg = _cfg(["--preset", "hier_anet", *argv])
    assert getattr(getattr(cfg, field[0]), field[1]) is want


def test_pallas_gru_flags_are_jax_only():
    """On the card the kernels always run: the port's parser has no switch
    to the plain path, and the preset's (JAX-only) field passes through."""
    for flag in ("--pallas_gru", "--no_pallas_gru"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag])
    assert _cfg([]).model.pallas_gru is False


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        _cfg(["--preset", "nope"])


def test_config_json_roundtrip_through_overrides():
    """A config the port's CLI makes round-trips through its own
    config.json and loads in the JAX package with the same fields."""
    cfg = _cfg(["--preset", "cmhse_full", "--margin", "0.25", "--dtype",
                "bfloat16", "--bucketed"])
    text = cfg.to_json()
    cfg2 = ExperimentConfig.from_json(text)
    assert cfg2 == cfg
    assert cfg2.loss.margin == 0.25
    assert cfg2.model.attention_pool is True
    assert cfg2.model.reconstruction is True
    jcfg = JaxExperimentConfig.from_json(text)
    assert json.loads(jcfg.to_json()) == json.loads(text)
    assert dataclasses.asdict(jcfg.data) == dataclasses.asdict(cfg.data)


def test_feature_dtype_follows_model_dtype():
    cfg = _cfg(["--preset", "hier_anet", "--feature_dtype", "bfloat16"])
    assert cfg.data.feature_dtype == "bfloat16"
    cfg = _cfg(["--preset", "hier_anet", "--dtype", "bfloat16"])
    assert cfg.data.feature_dtype == "bfloat16"
    cfg = _cfg(["--preset", "hier_anet", "--dtype", "float32"])
    assert cfg.data.feature_dtype == "float32"
    cfg = _cfg(["--preset", "hier_anet", "--dtype", "bfloat16",
                "--feature_dtype", "float32"])
    assert cfg.data.feature_dtype == "float32"


def test_vocab_cli_data_name_subdirectory(tmp_path):
    from cmhse_tpu_torch.cli.build_vocab import main as vocab_main

    sub = tmp_path / "anet_precomp"
    sub.mkdir()
    (sub / "train_captions.json").write_text(json.dumps(
        {"v_a": {"timestamps": [[0, 1]], "sentences": ["a man runs"],
                 "duration": 1.0}}))
    rc = vocab_main(["--data_path", str(tmp_path), "--data_name",
                     "anet_precomp", "--threshold", "1", "--platform", "cpu"])
    assert rc == 0
    assert (sub / "vocab.json").exists()
    with pytest.raises(SystemExit, match="SUBDIRECTORY"):
        vocab_main(["--data_path", str(tmp_path), "--data_name", "nope",
                    "--threshold", "1", "--platform", "cpu"])


def test_flat_override_clears_reconstruction():
    cfg = _cfg(["--preset", "cmhse_full", "--flat"])
    assert cfg.model.hierarchical is False
    assert cfg.model.reconstruction is False


def test_flat_with_explicit_reconstruction_still_rejected():
    with pytest.raises(ValueError, match="hierarchical"):
        _cfg(["--preset", "cmhse_full", "--flat", "--reconstruction"])


def test_legacy_flat_reconstruction_config_json_loads():
    raw = json.loads(get_preset("cmhse_full").to_json())
    raw["model"]["hierarchical"] = False
    raw["model"]["reconstruction"] = True
    loaded = ExperimentConfig.from_json(json.dumps(raw))
    assert loaded.model.reconstruction is False
    assert loaded.model.hierarchical is False


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(command: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX ``cmhse_tpu.cli.<command>.main`` builds, caught at
    its ``parse_args`` (most build it inside ``main``)."""
    mod = importlib.import_module(f"cmhse_tpu.cli.{command}")
    if hasattr(mod, "build_parser"):
        return mod.build_parser()

    def catch(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as got:
            mod.main([])
    return got.value.parser


def _options(parser: argparse.ArgumentParser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("command", COMMANDS)
def test_every_jax_option_is_ported_or_named(command, monkeypatch):
    port = importlib.import_module(f"cmhse_tpu_torch.cli.{command}")
    ours = _options(port.build_parser())
    jax_only = set(getattr(port, "JAX_ONLY_FLAGS", ()))
    later = set(getattr(port, "LATER_FLAGS", {}))
    theirs = _options(_jax_parser(command, monkeypatch))
    missing = theirs - ours - jax_only - later
    assert not missing, f"JAX options neither ported nor named: {missing}"
    assert not (jax_only | later) & ours
    assert (jax_only | later) <= theirs
    assert "--platform" in ours
    for item in getattr(port, "LATER_FLAGS", {}).values():
        assert item.startswith(("A.5", "A.6", "A.7"))


def _argv(command: str) -> list:
    return {
        "build_vocab": ["--data_path", "d"],
        "train": ["--synthetic"],
        "evaluate": ["run"],
        "import_torch": ["ckpt.pth.tar", "out"],
        "export_torch": ["run", "out.pth.tar"],
        "retrieve": ["run", "--query", "a man runs"],
        "serve_daemon": ["run", "--tcp", "127.0.0.1:0"],
    }[command]


@pytest.mark.parametrize("command", COMMANDS)
def test_commands_refuse_to_start_without_a_card(command, monkeypatch):
    """Without --platform cpu a command runs on the card, and raises
    resolve_device's error where there is none, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"cmhse_tpu_torch.cli.{command}")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mod.main(_argv(command))


def test_timing_helpers(tmp_path):
    """utils.timing: Timer measures its block, throughput counts warm-up
    and timed calls apart, profiler_trace writes a Chrome trace only when
    given a directory."""
    from cmhse_tpu_torch.utils.timing import Timer, profiler_trace, throughput

    calls = []
    with Timer() as t:
        rate = throughput(lambda x: calls.append(x) or x * 2,
                          (torch.ones(3),), iters=5, warmup=2)
    assert len(calls) == 7 and rate > 0 and t.elapsed > 0
    with profiler_trace(None):
        torch.ones(2).sum()
    assert not any(tmp_path.iterdir())
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(2).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
