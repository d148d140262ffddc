"""The ``cmhse_dsv2_lite`` configuration's benchmark pieces at toy sizes on
the CPU: its reference against the program (the stack, the objective and
its gradients, one step, a step from the program's state), the
``train_tower`` runner through the whole harness (a sound run is correct,
the faults are not), the routing numbers, the counts, and the
configuration file's stack settings against its published keys."""

import json

import pytest
import torch

import control
import run
from conftest import toy_sizes
from harness import common, counts_dsv2_lite
from harness import weights_dsv2_lite as tower_weights
from reference import cmhse_dsv2_lite as ref_model
from reference.data import pad_examples

CELL = "cmhse_dsv2_lite.train"
CPU = torch.device("cpu")
# the stack at a toy size: every kind of layer, a share of the experts
TOY_TOWER = {"hidden_size": 32, "num_hidden_layers": 3,
             "intermediate_size": 48, "num_attention_heads": 2,
             "kv_lora_rank": 16, "qk_nope_head_dim": 8,
             "qk_rope_head_dim": 4, "v_head_dim": 8, "routed_experts": 8,
             "experts_held": 4, "expert_offset": 2,
             "num_experts_per_tok": 2, "moe_intermediate_size": 16,
             "n_shared_experts": 1, "initializer_range": 0.2}


def _sizes():
    sizes = toy_sizes(common.load_json("cells", CELL))
    sizes["text_tower"] = dict(TOY_TOWER)
    return sizes


def _config():
    runner = common.load_module("runners", "train_tower")
    config = common.load_json("configs", "cmhse_dsv2_lite")
    mix = common.load_json("traffic", "anet_train")
    return runner.sized(config, mix, _sizes())


def _setup(seed=3):
    from cmhse_tpu_torch.config import ExperimentConfig
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.models.text_tower import TextTowerConfig

    config, mix = _config()
    cfg = ExperimentConfig.from_json(json.dumps(
        {k: config[k] for k in ("data", "model", "loss", "train")}))
    weights = tower_weights.make_weights(config, seed, CPU)
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu",
                  text_tower=TextTowerConfig.from_dict(config["text_tower"]))
    model.load_state_dict(weights)
    split = common.generator(mix).split(mix, seed, cfg.data.feat_dim,
                                        cfg.data.vocab_size, n_videos=12)
    d = config["data"]
    rows = [split[i] for i in range(len(split))]
    batch = pad_examples(rows, d["max_clips"], d["max_frames"],
                         d["max_sentences"], d["max_words"], "cpu")
    ref = ref_model.Reference(config["model"], config["loss"],
                              config["text_tower"])
    return config, cfg, weights, model, rows, batch, ref


def _program_batch(rows, cfg):
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.data.bucketing import BucketSpec

    d = cfg.data
    spec = BucketSpec(batch_size=len(rows), max_clips=d.max_clips,
                      max_frames=d.max_frames,
                      max_sentences=d.max_sentences, max_words=d.max_words,
                      feat_dim=d.feat_dim)
    return native.pack_batch_native(rows, spec).to("cpu")


def test_weights_cover_the_program_parameters():
    config, cfg, weights, model, *_ = _setup()
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == \
        {n: tuple(w.shape) for n, w in weights.items()}


def test_reference_text_encoder_matches_program():
    config, cfg, weights, model, rows, b, ref = _setup()
    with torch.no_grad():
        p, s = ref.encode_text(weights, b["words"], b["word_len"],
                               b["sent_len"])
        pp, ps = model.encode_text(b["words"], b["word_len"], b["sent_len"])
    assert torch.allclose(pp, p, atol=1e-5)
    assert torch.allclose(ps, s, atol=1e-5)


def test_reference_loss_and_gradients_match_program():
    from cmhse_tpu_torch.train.objective import total_loss

    config, cfg, weights, model, rows, b, ref = _setup()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref.loss(params, b)
    want.backward()
    batch = _program_batch(rows, cfg)
    model.train()
    got, _ = total_loss(model(batch), batch, cfg.loss)
    got.backward()
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    for n, p in model.named_parameters():
        g, r = p.grad, params[n].grad
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 2e-4 * scale, n


def test_reference_steps_match_program_given_its_routes():
    """One step from the seed's weights, then one from the program's state
    (its parameters and Adam's moments), the reference given the program's
    experts each time."""
    from cmhse_tpu_torch.train.state import create_train_state, train_step

    config, cfg, weights, model, rows, b, ref = _setup()
    out = ref_model.train_steps(
        ref, {k: v.clone() for k, v in weights.items()}, [b],
        lr=config["train"]["lr"], grad_clip=config["train"]["grad_clip"])
    state = create_train_state(cfg, model)
    batch = _program_batch(rows, cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = train_step(state, batch, cfg.loss)
    assert float(metrics["loss"]) == pytest.approx(out["losses"][0],
                                                   rel=1e-5)
    for n, p in model.named_parameters():
        change = float(torch.linalg.vector_norm((p.detach() - start[n])
                                                .double()))
        assert change == pytest.approx(out["change_norms"][n], rel=1e-3,
                                       abs=1e-9), n
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    adam = [state.optimizer.state[p] for p in params]
    moments = ({n: a["exp_avg"].clone() for n, a in zip(names, adam)},
               {n: a["exp_avg_sq"].clone() for n, a in zip(names, adam)},
               int(float(adam[0]["step"])))
    start = {n: p.detach().clone() for n, p in zip(names, params)}
    state, metrics = train_step(state, batch, cfg.loss)
    b["routes"] = [r.clone() for r in model.text_tower.routes()]
    out = ref_model.train_steps(ref, {k: v.clone() for k, v in start.items()},
                                [b], lr=config["train"]["lr"],
                                grad_clip=config["train"]["grad_clip"],
                                moments=moments)
    assert float(metrics["loss"]) == pytest.approx(out["losses"][0],
                                                   rel=1e-5)
    numbers = common.load_module("runners", "train_tower").route_numbers(
        out["route_logs"])
    assert numbers["route_mismatch"] == 0 and numbers["_route_rows"] > 0


def _run(hooks=None, seed=2**31 + 11):
    return run.run_cell(CELL, seed, 1.0, False, CPU, hooks=hooks,
                        sizes=_sizes())


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["route_mismatch"]["value"] == 0


def test_half_batch_is_not_correct():
    from cmhse_tpu_torch.train import loop

    res = _run({"train_step": control.half_batch(loop.train_step)})
    assert not res["correct"]


def test_state_left_unchanged_is_not_correct():
    from cmhse_tpu_torch.train import loop

    res = _run({"train_step": control.frozen(loop.train_step)})
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_route_numbers_excuse_only_near_ties():
    runner = common.load_module("runners", "train_tower")
    tie = runner.NEAR_TIE
    scores = torch.tensor([[0.5, 0.3, 0.2 + tie / 4, 0.2],
                           [0.5, 0.3, 0.15, 0.05]], dtype=torch.float64)
    own = torch.tensor([[0, 2], [0, 1]])
    log = {"own": own, "scores": scores,
           "live": torch.tensor([True, True])}
    near = runner.route_numbers([[{**log, "used": torch.tensor(
        [[0, 3], [1, 0]])}]])
    assert near == {"route_mismatch": 0, "_route_flips": 1,
                    "_route_flip_gap": pytest.approx(tie / 4),
                    "_route_rows": 2, "_route_drifted_flips": 0,
                    "_route_drifted_gap": 0.0}
    far = runner.route_numbers([[{**log, "used": torch.tensor(
        [[0, 2], [0, 3]])}]])
    assert far["route_mismatch"] == 1 and far["_route_flips"] == 1
    dead = runner.route_numbers([[{**log, "live": torch.tensor(
        [True, False]), "used": torch.tensor([[0, 2], [0, 3]])}]])
    assert dead["route_mismatch"] == 0 and dead["_route_rows"] == 1
    # a flip in a step from the reference's own parameters is reported only
    drift = runner.route_numbers([], [[{**log, "used": torch.tensor(
        [[0, 2], [0, 3]])}]])
    assert drift["route_mismatch"] == 0 and \
        drift["_route_drifted_flips"] == 1


def test_counts_at_published_widths():
    """A live token's forward FLOPs: about 162M in the dense layer, about
    114M in an expert layer where 3 of its 6 assignments are held here."""
    t = tower_weights.tower_settings(
        common.load_json("configs", "cmhse_dsv2_lite"))
    one_dense = counts_dsv2_lite.tower_token_flops(
        {**t, "num_hidden_layers": 1})
    per_moe = (counts_dsv2_lite.tower_token_flops(t) - one_dense) / 4
    assert one_dense == pytest.approx(162.0e6, rel=0.01)
    assert per_moe + 3 * counts_dsv2_lite.expert_flops(t) == \
        pytest.approx(114.0e6, rel=0.01)


def test_stack_settings_match_the_published_keys():
    """The port's settings made from the configuration's top-level keys
    (the published config's, with the two cuts ``reduced`` names) are
    DeepSeek-V2-Lite's whole, ``TextTowerConfig``'s defaults, but for the
    layers and the experts held."""
    import dataclasses

    from cmhse_tpu_torch.models.text_tower import TextTowerConfig

    config = common.load_json("configs", "cmhse_dsv2_lite")
    spec = common.benchmark_spec()
    entry = next(c for c in spec["configs"]
                 if c["name"] == "cmhse_dsv2_lite")
    assert entry["reduced"] == config["reduced"] == [
        "num_hidden_layers", "n_routed_experts"]
    assert config["published"] == {"num_hidden_layers": 27,
                                   "n_routed_experts": 64}
    got = TextTowerConfig.from_dict(tower_weights.tower_settings(config))
    assert got == dataclasses.replace(TextTowerConfig(), num_hidden_layers=5,
                                      experts_held=32, expert_offset=0)
    assert config["data"]["vocab_size"] == config["vocab_size"] == 102400


@pytest.mark.card
def test_tf32_control_fails_the_limits(card):
    """The reference in TF32 in the program's place, at the cell's widths
    on a batch of 16: some number reads past its committed limit."""
    runner = common.load_module("runners", "train_tower")
    c = common.load_json("cells", CELL)
    config = common.load_json("configs", c["config"])
    mix = common.load_json("traffic", c["traffic"])
    sizes = {"data": {"batch_size": 16}, "mix": {"videos": 256}}
    for seed in (1, 2):
        T = runner.prepare(c, config, mix, seed, card, sizes=sizes)
        runner.release(T)
        numbers = runner.judge_steps(T, tf32=True)
        assert any(numbers[k] > v for k, v in c["limits"].items())
