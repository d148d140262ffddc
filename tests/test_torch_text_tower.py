"""The text tower (``cmhse_tpu_torch/models/text_tower.py``, a DeepSeek-V2
decoder stack as CMHSE's sentence encoder) against the benchmark's plain
reference, ``benchmark/reference/cmhse_dsv2_lite.py``, on the CPU at a toy
size, on seeded weights: each layer kind's forward, the whole model's loss
and every gradient (dense products, and the card's live-row path through
the kernels' plain versions), one Adam step, the YaRN tables at the
published settings, the expert shares, the grouped forms' plain versions,
and the configuration's and a run's round trips."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cmhse_tpu_torch.config import ExperimentConfig, get_preset
from cmhse_tpu_torch.data import Batch
from cmhse_tpu_torch.data.datasets import CorrelatedSyntheticDataset
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.models import text_tower as tt
from cmhse_tpu_torch.ops import live_gemm
from cmhse_tpu_torch.train.objective import total_loss
from cmhse_tpu_torch.train.state import create_train_state, train_step

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import cmhse_dsv2_lite as ref_mod  # noqa: E402

torch.set_num_threads(2)

VOCAB = 200
# hidden 64, 4 heads, nope 16 / rope 8 / v 16, kv rank 32, 8 routed experts
# with 4 held (from 2), top-2, 1 shared, expert width 32, dense width 96,
# 1 dense + 2 MoE layers; kernels drawn wider than 0.02 so that the router
# separates its experts at this width
TOY = tt.TextTowerConfig(
    hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
    intermediate_size=96, num_attention_heads=4, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    routed_experts=8, experts_held=4, expert_offset=2, num_experts_per_tok=2,
    moe_intermediate_size=32, n_shared_experts=1, initializer_range=0.2)
# forward values in f32 against the reference's own f32 ops: a few ulps of
# embeddings near 1, sums over at most 96 products a layer
FWD_ATOL = 1e-6
# gradients by max error over the leaf's largest entry: backward sums in
# another order than autograd's (the grouped forms, the live-row products)
GRAD_RTOL = 2e-5


def _cfg():
    base = get_preset("cmhse_full")
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, embed_size=16, rnn_hidden=16,
                                  feat_dim=10),
        data=dataclasses.replace(base.data, feat_dim=10, vocab_size=VOCAB,
                                 batch_size=6, max_clips=4, max_frames=10,
                                 max_sentences=4, max_words=12))


def _model(cfg=None, tower=TOY, seed=0):
    cfg = cfg or _cfg()
    return CMHSE(cfg.model, VOCAB, device="cpu",
                 generator=torch.Generator().manual_seed(seed),
                 text_tower=tower)


def _ref(cfg=None, tower=TOY):
    cfg = cfg or _cfg()
    m = json.loads(cfg.to_json())
    return ref_mod.Reference(m["model"], m["loss"], dataclasses.asdict(tower))


def _batch(seed=1, b=6, c=4, f=10, s=4, w=12):
    g = torch.Generator().manual_seed(seed)
    clip_len = torch.randint(1, c + 1, (b,), generator=g)
    frame_len = torch.randint(1, f + 1, (b, c), generator=g)
    word_len = torch.randint(1, w + 1, (b, s), generator=g)
    slots = torch.arange(c)[None, :] < clip_len[:, None]
    frame_len, word_len = frame_len * slots, word_len * slots
    batch = Batch(frames=torch.randn(b, c, f, 10, generator=g),
                  frame_len=frame_len.int(), clip_len=clip_len.int(),
                  words=torch.randint(0, VOCAB, (b, s, w), generator=g).int(),
                  word_len=word_len.int(), sent_len=clip_len.int(),
                  video_ids=torch.arange(b).int(),
                  valid=torch.ones(b, dtype=torch.bool))
    ref_batch = {"frames": batch.frames, "frame_len": frame_len,
                 "clip_len": clip_len, "words": batch.words.long(),
                 "word_len": word_len, "sent_len": clip_len,
                 "ids": torch.arange(b), "valid": batch.valid}
    return batch, ref_batch


@pytest.fixture(params=["dense", "live_rows"])
def path(request, monkeypatch):
    """The CPU's dense products, or the card's live-row products (the
    kernels' plain versions on the CPU)."""
    if request.param == "live_rows":
        monkeypatch.setattr(live_gemm, "takes",
                            lambda x: x.dtype == torch.float32)
    return request.param


def _layer_inputs(seed=2, n=10, w=12):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, w + 1, (n,), generator=g).int()
    x = torch.randn(n, w, TOY.hidden_size, generator=g)
    live = torch.arange(w)[None, :] < lengths[:, None]
    return torch.where(live[..., None], x, 0.0), lengths, live


@pytest.mark.parametrize("kind", ["mla", "dense_mlp", "moe"])
def test_each_layer_kind_matches_reference(kind, path):
    model = _model()
    tower = model.text_tower
    p = {k: v.detach() for k, v in model.state_dict().items()}
    ref = _ref()
    x, lengths, live = _layer_inputs()
    tok = tt._Tokens(x, lengths)
    cos, sin = tower._rope(x.shape[1], x.device)
    with torch.no_grad():
        if kind == "mla":
            got = tower.layers[0].attn(x, tok, cos, sin)
            want = ref.mla(p, "text_tower.layers.0.attn.", x, live, cos, sin)
        elif kind == "dense_mlp":
            got = tower.layers[0].ffn(x, tok)
            want = ref.mlp(p, "text_tower.layers.0.ffn.", x)
        else:
            got, assigned = tower.layers[1].ffn(x, tok)
            want = ref.moe(p, "text_tower.layers.1.ffn.", x, live)
            used = ref.route_log[-1]["used"]
            held = (used >= TOY.expert_offset) & \
                (used < TOY.expert_offset + TOY.experts_held)
            assert int(assigned) == int((held & live.reshape(-1, 1)).sum())
    got = torch.where(live[..., None], got, 0.0)
    want = torch.where(live[..., None], want, 0.0)
    assert (got - want).abs().max().item() <= FWD_ATOL * max(
        1.0, want.abs().max().item())


def _grads_match(model, params):
    for n, prm in model.named_parameters():
        r = params[n].grad
        scale = r.abs().max().item() + 1e-30
        assert (prm.grad - r).abs().max().item() <= GRAD_RTOL * scale, n


def test_loss_and_every_gradient_match_reference(path):
    cfg = _cfg()
    model = _model(cfg)
    model.train()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    batch, ref_batch = _batch()
    want = _ref(cfg).loss(params, ref_batch)
    want.backward()
    got, _ = total_loss(model(batch), batch, cfg.loss)
    got.backward()
    assert abs(float(got.detach()) - float(want.detach())) <= \
        1e-6 * abs(float(want.detach()))
    _grads_match(model, params)
    # the tower's leaves all take part: a gradient somewhere in each
    assert all(float(p.grad.abs().max()) > 0 for n, p in
               model.named_parameters() if n.startswith("text_tower."))


def test_one_adam_step_matches_reference(path):
    cfg = _cfg()
    model = _model(cfg)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch, ref_batch = _batch(seed=3)
    out = ref_mod.train_steps(_ref(cfg), weights, [ref_batch],
                              lr=cfg.train.lr, grad_clip=cfg.train.grad_clip)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model)
    state, metrics = train_step(state, batch, cfg.loss)
    assert float(metrics["loss"]) == pytest.approx(out["losses"][0],
                                                   rel=1e-6)
    for n, p in model.named_parameters():
        change = float(torch.linalg.vector_norm((p.detach() - start[n])
                                                .double()))
        assert change == pytest.approx(out["change_norms"][n], rel=1e-4,
                                       abs=1e-9), n


def test_yarn_tables_follow_the_formula_at_published_settings():
    cfg = tt.TextTowerConfig()
    d, theta, factor = 64, 10000.0, 40.0

    def turns(r):
        return d * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(theta))

    low, high = max(math.floor(turns(32)), 0), min(math.ceil(turns(1)), 63)
    assert (low, high) == (10, 23)
    want = []
    for i in range(32):
        extra = theta ** (-2 * i / d)
        m = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / factor * (1 - m) + extra * m)
    got = tt.yarn_inv_freq(cfg)
    assert np.allclose(got.numpy(), want, rtol=1e-12, atol=0)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert tt.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2,
                                                  rel=1e-12)
    cos, sin = tt.rope_tables(cfg, 32, "cpu")
    pos = torch.arange(32, dtype=torch.float64)[:, None]
    ang = torch.cat([pos * got[None, :]] * 2, dim=-1)
    assert torch.allclose(cos.double(), ang.cos(), atol=1e-7)
    assert torch.allclose(sin.double(), ang.sin(), atol=1e-7)
    rcos, rsin = ref_mod.rope_tables(dataclasses.asdict(cfg), 32, "cpu")
    assert torch.equal(rcos, cos) and torch.equal(rsin, sin)


def test_rope_deinterleaves_the_pairs_before_rotating():
    x = torch.arange(8, dtype=torch.float32)[None, :]
    cos, sin = torch.zeros(1, 8), torch.ones(1, 8)
    # de-interleaved: (0, 2, 4, 6, 1, 3, 5, 7); rotate-half of it
    assert tt.apply_rope(x, cos, sin).tolist() == \
        [[-1.0, -3.0, -5.0, -7.0, 0.0, 2.0, 4.0, 6.0]]


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two chips' shares of an expert layer (experts 0-3 and 4-7 of 8),
    with the shared expert counted once, give the layer that holds all 8."""
    whole = dataclasses.replace(TOY, experts_held=8, expert_offset=0)
    full = _model(tower=whole)
    x, lengths, live = _layer_inputs(seed=4)
    tok = tt._Tokens(x, lengths)
    layer = full.text_tower.layers[1].ffn
    with torch.no_grad():
        want, _ = layer(x, tok)
        shared = layer.shared(x, tok)
        parts = []
        for offset in (0, 4):
            share = tt.MoE(dataclasses.replace(whole, experts_held=4,
                                               expert_offset=offset),
                           torch.Generator())
            sd = {k: v for k, v in layer.state_dict().items()}
            sd["experts_gu"] = sd["experts_gu"][offset:offset + 4]
            sd["experts_down"] = sd["experts_down"][offset:offset + 4]
            share.load_state_dict(sd)
            out, _ = share(x, tok)
            parts.append(out - shared)
    got = parts[0] + parts[1] + shared
    assert torch.allclose(torch.where(live[..., None], got, 0.0),
                          torch.where(live[..., None], want, 0.0),
                          atol=1e-6)


def test_grouped_plain_forms_match_a_per_expert_loop():
    g = torch.Generator().manual_seed(6)
    rows, k, held, d, n = 40, 3, 5, 12, 7
    live = torch.rand(rows, generator=g) < 0.7
    top = torch.rand(rows, 9, generator=g).topk(k).indices
    tok, assign, gstarts, valid = live_gemm.moe_plan(top, live, held, 2)
    x = torch.randn(rows, d, generator=g)
    w = torch.randn(held, d, n, generator=g)
    scale = torch.rand(rows * k, generator=g)
    got = live_gemm.moe_rows(x, w, gstarts, torch.zeros(rows * k, n),
                             a_idx=tok, c_idx=assign, scale=scale)
    dy = torch.randn(rows * k, n, generator=g)
    dw = live_gemm.moe_reduce(x, dy, gstarts, a_idx=tok, g_idx=assign)
    want = torch.zeros(rows * k, n)
    want_dw = torch.zeros(held, d, n)
    slot_of = {int(a): s for s, a in enumerate(assign.tolist())}
    for e in range(held):
        for r in range(rows):
            for j in range(k):
                if not live[r] or int(top[r, j]) != 2 + e:
                    continue
                a = r * k + j
                want[a] = scale[slot_of[a]] * (x[r] @ w[e])
                want_dw[e] += torch.outer(x[r], dy[a])
    assert torch.allclose(got, want, atol=1e-5)
    assert torch.allclose(dw, want_dw, atol=1e-5)
    # the plan: slots sorted by expert, stable, valid below gstarts[held]
    total = int(gstarts[held])
    assert total == int(sum(((top[r] >= 2) & (top[r] < 7)).sum()
                            for r in range(rows) if live[r]))
    assert valid.sum() == total
    experts = (top.reshape(-1)[assign.long()[:total]] - 2).tolist()
    assert experts == sorted(experts)


def test_text_tower_config_round_trips_and_refuses():
    cfg = dataclasses.replace(TOY, assumed=("one", "two"))
    again = tt.TextTowerConfig.from_json(cfg.to_json())
    assert again == cfg
    assert tt.TextTowerConfig.from_dict(json.loads(cfg.to_json())) == cfg
    with pytest.raises(ValueError, match="unknown"):
        tt.TextTowerConfig.from_dict({"hidden": 3})
    with pytest.raises(ValueError, match="router"):
        dataclasses.replace(TOY, expert_offset=6)
    bf16 = dataclasses.replace(_cfg().model, dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="float32"):
        CMHSE(bf16, VOCAB, device="cpu", text_tower=TOY)


def test_fit_writes_and_reloads_a_tower_run(tmp_path):
    from cmhse_tpu_torch.train.checkpoint import (load_text_tower,
                                                  restore_for_eval)
    from cmhse_tpu_torch.train.loop import fit

    cfg = _cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=1, checkpoint_dir=str(tmp_path / "run"),
        val_step=0, log_step=1))
    d = cfg.data
    ds = CorrelatedSyntheticDataset(num_videos=12, feat_dim=d.feat_dim,
                                    vocab_size=VOCAB, max_clips=d.max_clips,
                                    max_frames=d.max_frames,
                                    max_words=d.max_words, seed=0)
    val = CorrelatedSyntheticDataset(num_videos=6, feat_dim=d.feat_dim,
                                     vocab_size=VOCAB, max_clips=d.max_clips,
                                     max_frames=d.max_frames,
                                     max_words=d.max_words, seed=1)
    state, _ = fit(cfg, ds, val, device="cpu", text_tower=TOY)
    assert state.step == 2
    with open(tmp_path / "run" / "log.jsonl") as f:
        steps = [e for e in map(json.loads, f) if e["event"] == "train_step"]
    assert [e["moe.assignments"] > 0 for e in steps] == [True, True]
    assert steps[1]["tower.tokens"] > steps[0]["tower.tokens"] > 0
    assert load_text_tower(str(tmp_path / "run")) == TOY
    model, rcfg = restore_for_eval(str(tmp_path / "run"), device="cpu")
    assert model.text_tower is not None and model.text_tower.cfg == TOY
    assert rcfg == ExperimentConfig.from_json(cfg.to_json())
    trained = dict(state.model.state_dict())
    assert set(model.state_dict()) == set(trained)
    from cmhse_tpu_torch.cli import serve_daemon

    with pytest.raises(NotImplementedError, match="text tower"):
        serve_daemon.build_context(str(tmp_path / "run"), None, "val",
                                   device="cpu")


def test_cli_train_takes_a_text_tower_file(tmp_path):
    from cmhse_tpu_torch.cli import train as cli_train
    from cmhse_tpu_torch.train.checkpoint import load_text_tower

    path = tmp_path / "tower.json"
    path.write_text(TOY.to_json())
    run = tmp_path / "run"
    assert cli_train.main([
        "--preset", "cmhse_full", "--synthetic", "--synthetic_videos", "16",
        "--feat_dim", "10", "--embed_size", "16", "--rnn_hidden", "16",
        "--vocab_size", str(VOCAB), "--max_clips", "4", "--max_frames", "10",
        "--max_sentences", "4", "--max_words", "12", "--batch_size", "8",
        "--num_epochs", "1", "--val_step", "0", "--logger_name", str(run),
        "--text_tower", str(path), "--platform", "cpu"]) == 0
    assert load_text_tower(str(run)) == TOY


def test_interop_and_serving_refuse_a_tower_model(tmp_path):
    from cmhse_tpu_torch.interop import params_to_jax_tree

    model = _model()
    with pytest.raises(NotImplementedError, match="text tower"):
        params_to_jax_tree(model.state_dict())
    with pytest.raises(NotImplementedError, match="text tower"):
        model.load_jax_params({})
