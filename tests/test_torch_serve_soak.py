"""``scripts/torch_serve_soak.py`` on the CPU at a small width: query
clients and the add -> remove churn run against one live daemon for two
seconds; no error, no stuck thread, the churn compacts, and the gallery is
its start-up rows again. The run has a time limit of its own, so a hang
fails the test."""

import ast
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "torch_serve_soak.py"
LIMIT_S = 180


def _soak():
    spec = importlib.util.spec_from_file_location("torch_serve_soak", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_on_cpu_churns_compacts_and_ends_clean():
    soak = _soak()
    out, answers = {}, {}

    def run():
        try:
            out["summary"] = soak.main([
                "--platform", "cpu", "--seconds", "2", "--clients", "2",
                "--n_val", "16", "--feat_dim", "32", "--embed", "32"],
                answers=answers)
        except Exception as e:  # reported below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=LIMIT_S)
    assert not t.is_alive(), f"the soak did not end in {LIMIT_S} s"
    assert "error" not in out, out.get("error")
    s = out["summary"]
    assert s["ok"], s
    assert s["errors"] == [] and s["stuck_threads"] == 0
    assert s["add_remove_cycles"] >= 1 and s["compactions"] >= 1
    assert s["queries"] > 0 and s["final_valid_rows"] == 16
    assert s["daemon_stopped"] and not s["streaming_engaged"]
    # every query's round trip, beside the daemon's last-1,024 stats
    assert 0 < s["client_latency_ms_p50"] <= s["client_latency_ms_p99"] \
        <= s["client_latency_ms_max"]
    # the final answers handed to a caller: top-10 of each text and of 4
    # val videos, no churned key
    assert len(answers["text"]) == len(soak.TEXTS)
    assert len(answers["video_keys"]) == len(answers["video"]) == 4
    for hits in answers["text"] + answers["video"]:
        assert len(hits) == 10
        assert not any(h["key"].startswith("v_churn") for h in hits)


def test_soak_defaults_to_the_card():
    """The JAX soak's flags and defaults, with ``--platform gpu`` the
    default; without a card the run raises before it builds anything."""
    soak = _soak()
    args = soak.build_parser().parse_args([])
    assert (args.seconds, args.clients, args.batch_window_ms, args.n_val,
            args.feat_dim, args.embed, args.synthetic_gallery,
            args.compact_threshold, args.quantized, args.platform) == \
        (300.0, 4, 5.0, 64, 512, 512, 0, 0.05, False, "gpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--seconds", "0"])


def test_soak_imports_nothing_of_jax():
    tree = ast.parse(SCRIPT.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "flax", "cmhse_tpu", "bench",
                        "serve_bench"}, sorted(names)
    assert "cmhse_tpu_torch" in roots
