"""The plain reference against the program at toy sizes on the CPU:
encoders, the objective, its gradients, one clipped Adam step, and a step
from the program's state after earlier steps."""


import pytest
import torch

from conftest import TOY
from harness import common
from harness.weights import make_weights
from reference import cmhse as ref_model
from reference.data import pad_examples

CONFIGS = ["cmhse_full", "didemo"]


def _setup(name: str, seed: int = 3):
    from cmhse_tpu_torch.config import ExperimentConfig
    from cmhse_tpu_torch.models import CMHSE

    config = common.load_json("configs", name)
    config = {**config, **{k: {**config[k], **TOY[k]}
                           for k in ("data", "model")}}
    cfg = ExperimentConfig.from_json(__import__("json").dumps(
        {k: config[k] for k in ("data", "model", "loss", "train")}))
    weights = make_weights(config["model"], config["data"]["vocab_size"],
                           seed, torch.device("cpu"))
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    model.load_state_dict(weights)
    mix = common.load_json("traffic", "anet_train" if name == "cmhse_full"
                           else "didemo_train")
    split = common.generator(mix).split(mix, seed, cfg.data.feat_dim,
                                cfg.data.vocab_size, n_videos=12)
    d = config["data"]
    rows = [split[i] for i in range(len(split))]
    batch = pad_examples(rows, d["max_clips"], d["max_frames"],
                         d["max_sentences"], d["max_words"], "cpu")
    return config, cfg, weights, model, rows, batch


def _program_batch(rows, cfg):
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.data.bucketing import BucketSpec

    d = cfg.data
    spec = BucketSpec(batch_size=len(rows), max_clips=d.max_clips,
                      max_frames=d.max_frames,
                      max_sentences=d.max_sentences, max_words=d.max_words,
                      feat_dim=d.feat_dim)
    return native.pack_batch_native(rows, spec).to("cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_encoders_match_program(name):
    config, cfg, weights, model, rows, b = _setup(name)
    ref = ref_model.Reference(config["model"], config["loss"])
    with torch.no_grad():
        v, c = ref.encode_video(weights, b["frames"], b["frame_len"],
                                b["clip_len"])
        p, s = ref.encode_text(weights, b["words"], b["word_len"],
                               b["sent_len"])
        pv, pc = model.encode_video(b["frames"], b["frame_len"],
                                    b["clip_len"])
        pp, ps = model.encode_text(b["words"], b["word_len"], b["sent_len"])
    for got, want in ((pv, v), (pc, c), (pp, p), (ps, s)):
        assert torch.allclose(got, want, atol=1e-5), (got - want).abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_program(name):
    from cmhse_tpu_torch.train.objective import total_loss

    config, cfg, weights, model, rows, b = _setup(name)
    ref = ref_model.Reference(config["model"], config["loss"])
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref.loss(params, b)
    want.backward()
    batch = _program_batch(rows, cfg)
    model.train()
    got, _ = total_loss(model(batch), batch, cfg.loss)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for n, p in model.named_parameters():
        g, r = p.grad, params[n].grad
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 2e-4 * scale, n


@pytest.mark.parametrize("name", CONFIGS)
def test_one_step_matches_program(name):
    from cmhse_tpu_torch.train.state import create_train_state, train_step

    config, cfg, weights, model, rows, b = _setup(name)
    ref = ref_model.Reference(config["model"], config["loss"])
    out = ref_model.train_steps(ref, weights, [b], lr=config["train"]["lr"],
                                grad_clip=config["train"]["grad_clip"])
    state = create_train_state(cfg, model)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = train_step(state, _program_batch(rows, cfg), cfg.loss)
    assert abs(float(metrics["loss"]) - out["losses"][0]) <= \
        1e-5 * out["losses"][0]
    for n, p in model.named_parameters():
        change = float(torch.linalg.vector_norm((p.detach() - start[n])
                                                .double()))
        assert change == pytest.approx(out["change_norms"][n], rel=1e-3,
                                       abs=1e-9), n


@pytest.mark.parametrize("name", CONFIGS)
def test_step_from_program_state_matches_program(name):
    """The reference's late step: from the program's parameters and Adam
    state after two steps, one more step agrees with the program's."""
    from cmhse_tpu_torch.train.state import create_train_state, train_step

    config, cfg, weights, model, rows, b = _setup(name)
    ref = ref_model.Reference(config["model"], config["loss"])
    state = create_train_state(cfg, model)
    batch = _program_batch(rows, cfg)
    for _ in range(2):
        state, _ = train_step(state, batch, cfg.loss)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    adam = [state.optimizer.state[p] for p in params]
    moments = ({n: a["exp_avg"].clone() for n, a in zip(names, adam)},
               {n: a["exp_avg_sq"].clone() for n, a in zip(names, adam)},
               int(float(adam[0]["step"])))
    start = {n: p.detach().clone() for n, p in zip(names, params)}
    out = ref_model.train_steps(ref, start, [b], lr=config["train"]["lr"],
                                grad_clip=config["train"]["grad_clip"],
                                moments=moments)
    state, metrics = train_step(state, batch, cfg.loss)
    assert abs(float(metrics["loss"]) - out["losses"][0]) <= \
        1e-5 * out["losses"][0]
    for n, p in zip(names, params):
        change = float(torch.linalg.vector_norm((p.detach() - start[n])
                                                .double()))
        assert change == pytest.approx(out["change_norms"][n], rel=1e-3,
                                       abs=1e-9), n


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11,
                      -2.5])
    r = ref_model.tf32_round(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -2.5]
