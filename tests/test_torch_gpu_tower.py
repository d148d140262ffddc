"""Card-only tests of the text tower (``models/text_tower.py``): the grouped
forms of ``csrc/live_gemm.cu`` (kernels ``moe_*``) against their plain
versions at the published shapes of DeepSeek-V2-Lite's routed experts and
at odd ones, their capture in a CUDA graph, the tower's forward and
gradients on the card against the CPU's plain path at a middle size, and a
captured training step against an eager one.

Marked ``gpu``; they skip (from a fixture, never at import) where there is
no CUDA device. This file imports neither JAX nor the JAX package::

    python -m pytest --noconftest tests/test_torch_gpu_tower.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmhse_tpu_torch.config import get_preset
from cmhse_tpu_torch.data import Batch
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.models.text_tower import TextTower, TextTowerConfig
from cmhse_tpu_torch.ops import cuda_lib, live_gemm
from cmhse_tpu_torch.train import create_train_state, train_step
from cmhse_tpu_torch.train.state import _update

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)

# max abs error relative to the largest entry: f32 sums of up to K = 2,816
# products, or a group's ~300 slots, in another order than cuBLAS's
MOE_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see README, "
                    "'PyTorch/CUDA port')")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _routing(rows, live_share, experts, k, held, offset, dev, seed):
    """A plan of ``rows`` token rows, about ``live_share`` of them live,
    each choosing ``k`` distinct experts of ``experts``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    live = torch.rand(rows, generator=gen, device=dev) < live_share
    top = torch.rand(rows, experts, generator=gen, device=dev).topk(k).indices
    return live, live_gemm.moe_plan(top, live, held, offset)


def _close(a, b, name):
    assert a.shape == b.shape, name
    assert torch.isfinite(a).all(), name
    err = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
    assert err.item() <= MOE_RTOL, (name, err.item())


def _run_forms(dev, rows, d, width, groups, k, live_share, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    _, (tok, assign, gstarts, valid) = _routing(
        rows, live_share, 2 * groups, k, groups, 0, dev, seed)
    cap = rows * k
    x, dy = randn(rows, d), randn(rows, d)
    w_gu, w_down = randn(groups, d, 2 * width), randn(groups, width, d)
    act, d_gu = randn(cap, width), randn(cap, 2 * width)
    scale = torch.rand(cap, device=dev, generator=gen)
    rows_calls = {
        "gate_up": (x, w_gu, (cap, 2 * width), dict(a_idx=tok)),
        "down": (act, w_down, (cap, d), dict(c_idx=assign, scale=scale)),
        "down_dx": (dy, w_down, (cap, width), dict(a_idx=tok, w_nk=True)),
        "gate_up_dx": (d_gu, w_gu, (cap, d), dict(c_idx=assign, w_nk=True)),
    }
    got, want = {}, {}
    for name, (a, w, shape, kw) in rows_calls.items():
        got[name] = live_gemm.moe_rows(a, w, gstarts,
                                       torch.zeros(shape, device=dev), **kw)
        want[name] = live_gemm.moe_rows_plain(
            a, w, gstarts, torch.zeros(shape, device=dev), **kw)
    got["dw_down"] = live_gemm.moe_reduce(act, dy, gstarts, g_idx=tok)
    want["dw_down"] = live_gemm.moe_reduce_plain(act, dy, gstarts, g_idx=tok)
    got["dw_gu"] = live_gemm.moe_reduce(x, d_gu, gstarts, a_idx=tok)
    want["dw_gu"] = live_gemm.moe_reduce_plain(x, d_gu, gstarts, a_idx=tok)
    return got, want


@pytest.mark.parametrize("rows,d,width,groups,k,live", [
    # the cell's: 512 sentences x 32 slots, ~19% live, 6 of 64 experts,
    # 32 held: ~300 slots an expert; 2048 -> 2 x 1408, 1408 -> 2048
    (16384, 2048, 1408, 32, 6, 0.19),
    # odd widths (4-byte copies), one group, few rows
    (37, 30, 18, 1, 2, 1.0),
    (300, 64, 48, 7, 3, 0.5),
])
def test_moe_forms_match_plain(cuda, rows, d, width, groups, k, live):
    cuda_lib.reset_launches()
    got, want = _run_forms(cuda, rows, d, width, groups, k, live, seed=rows)
    for name in got:
        _close(got[name], want[name], name)
    assert cuda_lib.launches == {("live_gemm", "float32", "moe_rows"): 4,
                                 ("live_gemm", "float32", "moe_reduce"): 2}


def test_moe_forms_with_no_assignment(cuda):
    """Every row dead: the row form writes nothing, the reduction zeros."""
    dev = cuda
    top = torch.zeros(64, 2, dtype=torch.long, device=dev)
    top[:, 1] = 1
    tok, assign, gstarts, valid = live_gemm.moe_plan(
        top, torch.zeros(64, dtype=torch.bool, device=dev), 4, 0)
    assert int(gstarts[-1]) == 0 and not valid.any()
    a = torch.randn(64, 16, device=dev)
    out = torch.full((128, 8), 7.0, device=dev)
    live_gemm.moe_rows(a, torch.randn(4, 16, 8, device=dev), gstarts, out,
                       a_idx=tok)
    assert (out == 7.0).all()
    dw = live_gemm.moe_reduce(a, torch.randn(128, 8, device=dev), gstarts,
                              a_idx=tok)
    assert (dw == 0).all()


def test_moe_plan_and_forms_replay_in_a_graph(cuda):
    """The plan and both forms captured once replay each new routing's own
    groups: no host read, no grid sized by the data."""
    dev = cuda
    rows, d, width, groups, k = 2048, 128, 96, 8, 3
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, d, device=dev, generator=gen)
    w = torch.randn(groups, d, width, device=dev, generator=gen)
    scores = torch.rand(rows, 2 * groups, device=dev, generator=gen)
    live = torch.rand(rows, device=dev, generator=gen) < 0.3

    def step():
        top = scores.topk(k).indices
        tok, assign, gstarts, valid = live_gemm.moe_plan(top, live, groups,
                                                         0)
        y = live_gemm.moe_rows(x, w, gstarts,
                               torch.zeros(rows * k, width, device=dev),
                               a_idx=tok, c_idx=assign)
        dw = live_gemm.moe_reduce(x, y, gstarts, a_idx=tok, g_idx=assign)
        return y, dw

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, dw_g = step()
    for seed in (2, 3):
        g2 = torch.Generator(device=dev).manual_seed(seed)
        scores.copy_(torch.rand(rows, 2 * groups, device=dev, generator=g2))
        live.copy_(torch.rand(rows, device=dev, generator=g2) < 0.6)
        graph.replay()
        y, dw = step()
        torch.cuda.synchronize()
        assert torch.equal(y_g, y) and torch.equal(dw_g, dw)


def _middle_tower():
    return TextTowerConfig(
        hidden_size=512, num_hidden_layers=3, intermediate_size=1024,
        num_attention_heads=4, kv_lora_rank=128, qk_nope_head_dim=64,
        qk_rope_head_dim=32, v_head_dim=64, routed_experts=16,
        experts_held=8, expert_offset=4, num_experts_per_tok=4,
        moe_intermediate_size=256, n_shared_experts=2)


def _sentences(n, w, vocab, seed):
    rng = np.random.RandomState(seed)
    lengths = np.where(rng.rand(n) < 0.8,
                       np.clip(1 + rng.poisson(12.5, n), 4, w), 0)
    ids = rng.randint(0, vocab, (n, w))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(lengths.astype(np.int32)))


def test_tower_on_card_matches_cpu(cuda):
    """Forward and every gradient of a middle-size tower: the card's K5
    and grouped forms against the CPU's dense plain path. Routing is the
    same wherever no two scores nearly tie; the comparison leaves out
    nothing, so a flipped expert would show."""
    cfg = _middle_tower()
    tower = TextTower(cfg, 1000, 256, torch.Generator().manual_seed(3))
    ids, lengths = _sentences(128, 32, 1000, 4)
    gen = torch.Generator().manual_seed(5)
    probe = torch.randn(128, 256, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        t = tower.to(dev)
        t.zero_grad()
        emb = t(ids.to(dev), lengths.to(dev))
        (emb * probe.to(dev)).sum().backward()
        routes = [r.cpu() for r in t.routes()]
        out[str(dev)] = (emb.detach().cpu(), routes,
                         {n: p.grad.detach().cpu()
                          for n, p in t.named_parameters()})
    (e_c, r_c, g_c), (e_g, r_g, g_g) = out["cpu"], out[str(cuda)]
    live = (torch.arange(32)[None, :] < lengths[:, None]).reshape(-1)
    for a, b in zip(r_c, r_g):
        assert torch.equal(a[live].sort(-1).values, b[live].sort(-1).values)
    assert (e_g - e_c).abs().max().item() <= 1e-5
    for n in g_c:
        scale = g_c[n].abs().max().clamp_min(1e-30)
        err = ((g_g[n] - g_c[n]).abs().max() / scale).item()
        assert err <= 2e-4, (n, err)


def test_tower_train_step_replays_as_eager(cuda):
    """A captured train_step of CMHSE with a tower equals the eager step
    bit for bit, and the step is captured (no host read in it)."""
    base = get_preset("cmhse_full")
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, embed_size=64,
                                        rnn_hidden=64, feat_dim=32),
        data=dataclasses.replace(base.data, feat_dim=32, vocab_size=1000,
                                 batch_size=16, max_frames=16, max_words=32))
    tcfg = _middle_tower()
    states = []
    for _ in range(2):
        model = CMHSE(cfg.model, 1000, device=cuda,
                      generator=torch.Generator().manual_seed(7),
                      text_tower=tcfg)
        states.append(create_train_state(cfg, model))
    rng = np.random.RandomState(8)
    b, c, f, s, w = 16, 8, 16, 8, 32
    for i in range(3):
        clip_len = np.clip(1 + rng.poisson(2.65, b), 1, 8).astype(np.int32)
        frame_len = rng.randint(4, f + 1, (b, c)).astype(np.int32)
        word_len = np.clip(1 + rng.poisson(12.5, (b, s)), 4, w).astype(
            np.int32)
        mask = np.arange(c)[None, :] < clip_len[:, None]
        frame_len *= mask
        word_len *= mask
        batch = Batch(
            frames=torch.from_numpy(rng.randn(b, c, f, 32).astype(
                np.float32)),
            frame_len=torch.from_numpy(frame_len),
            clip_len=torch.from_numpy(clip_len),
            words=torch.from_numpy(rng.randint(0, 1000, (b, s, w)).astype(
                np.int32)),
            word_len=torch.from_numpy(word_len),
            sent_len=torch.from_numpy(clip_len.copy()),
            video_ids=torch.arange(b, dtype=torch.int32),
            valid=torch.ones(b, dtype=torch.bool))
        _, m0 = train_step(states[0], batch, cfg.loss)
        m1 = _update(states[1], batch.to(cuda), cfg.loss)
        states[1].step += 1
        assert float(m0["loss"]) == float(m1["loss"]), i
    assert states[0].graph_refused is None
    assert states[0].graph_replays == 2
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    counts = states[0].model.text_tower.counters()
    assert counts == states[1].model.text_tower.counters()
    assert counts["moe.assignments"] > 0
