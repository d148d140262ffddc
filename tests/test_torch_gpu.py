"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version (every variant, at tile-edge shapes), the refusals of
what a kernel cannot take, and the encode path and one train step on the
card against the CPU.

Marked ``gpu``; they skip (from a fixture, never at import) where there is
no CUDA device. This file imports neither JAX nor the JAX package, so it
also runs on a machine without JAX::

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmhse_tpu_torch.config import ExperimentConfig, ModelConfig
from cmhse_tpu_torch.data import Batch
from cmhse_tpu_torch.models import CMHSE, ReconstructionDecoder
from cmhse_tpu_torch.ops import gru_kernel, rankcount_kernel, simhinge_kernel
from cmhse_tpu_torch.train import create_train_state, total_loss, train_step
from cmhse_tpu_torch.ops.topk import dense_sim_topk, streaming_sim_topk

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (see README, "
                    "'PyTorch/CUDA port')")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gru_inputs(b, t, h, seed, zero_rows=()):
    rng = np.random.RandomState(seed)
    xw = rng.randn(b, t, 3 * h).astype(np.float32)
    w_h = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_h = (rng.randn(3 * h) * 0.1).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[list(zero_rows)] = 0
    return [torch.from_numpy(a) for a in (xw, w_h, b_h, lengths)]


# (B, T, H): tiny; rows not a multiple of the block's 8; H > 4 * 256 (some
# threads own two groups of 4 units) with > 48 KB of shared memory; a wider H
@pytest.mark.parametrize("b,t,h", [(8, 6, 16), (37, 9, 64), (9, 3, 1100),
                                   (24, 12, 256)])
def test_gru_fwd_matches_plain(cuda, b, t, h):
    args = _gru_inputs(b, t, h, seed=b + t + h, zero_rows=(0, b - 1))
    want_outs, want_final = gru_kernel.gru_recurrence_plain(
        *[a.to(cuda) for a in args])
    before = gru_kernel.launches
    outs, final = gru_kernel.gru_recurrence(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert gru_kernel.launches == before + 1
    # f32; the sums over K = H run in another order than cuBLAS's
    torch.testing.assert_close(outs, want_outs, atol=1e-5, rtol=0)
    torch.testing.assert_close(final, want_final, atol=1e-5, rtol=0)
    assert torch.count_nonzero(final[0]) == 0  # length-0 row keeps h0 = 0


def test_gru_fwd_rejects_what_it_does_not_take(cuda):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(4, 3, 8, 0)]
    with pytest.raises(TypeError):
        gru_kernel.gru_recurrence(xw.double(), w_h, b_h, lengths)
    with pytest.raises(TypeError):
        gru_kernel.gru_recurrence(xw, w_h, b_h, lengths.long())
    with pytest.raises(ValueError):
        gru_kernel.gru_recurrence(xw.transpose(0, 1).contiguous()
                                  .transpose(0, 1), w_h, b_h, lengths)
    before = gru_kernel.save_gates_launches
    outs, _ = gru_kernel.gru_recurrence(xw, w_h.requires_grad_(), b_h,
                                        lengths)
    assert type(outs.grad_fn).__name__ == "TrainableGRUBackward"
    assert gru_kernel.save_gates_launches == before + 1
    xw6, w_h6, b_h6, lengths6 = [a.to(cuda) for a in _gru_inputs(4, 3, 6, 0)]
    with pytest.raises(ValueError):  # H not a multiple of 4
        gru_kernel.gru_recurrence(xw6, w_h6, b_h6, lengths6)


def test_gru_fwd_takes_an_offset_view(cuda):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(5, 4, 12, 3)]
    flat = torch.empty(xw.numel() + 1, device=cuda)
    xw_off = flat[1:].view(xw.shape)  # contiguous, off 16-byte alignment
    xw_off.copy_(xw)
    got = gru_kernel.gru_recurrence(xw_off, w_h, b_h, lengths)
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _exact_rows(rng, n, d):
    """Rows of multiples of 2**-10 with norm ~1: every dot product is exact
    in f32 whatever the summation order, so counts must match exactly."""
    x = rng.randn(n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (np.round(x * 1024) / 1024).astype(np.float32)


@pytest.mark.parametrize("q,n,d", [(64, 256, 32), (50, 300, 32),
                                   (130, 1000, 100)])
def test_rankcount_matches_plain_exactly(cuda, q, n, d):
    rng = np.random.RandomState(q + n)
    queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda)
    gallery = torch.from_numpy(_exact_rows(rng, n, d)).to(cuda)
    pos_idx = torch.from_numpy(rng.randint(0, n, q)).to(cuda)
    pos = (queries * gallery[pos_idx]).sum(1)
    pos[3] = float("nan")
    valid = torch.from_numpy(rng.rand(n) > 0.2).to(cuda)
    for gv, pi in ((None, None), (valid, pos_idx)):
        want = rankcount_kernel.violation_counts_plain(queries, gallery, pos,
                                                       gv, pi)
        got = rankcount_kernel.violation_counts(queries, gallery, pos, gv, pi)
        assert torch.equal(got, want)
        ranks = rankcount_kernel.rank_counts(queries, gallery, pos, gv, pi)
        worst = n if gv is None else int(gv.sum())
        assert int(ranks[3]) == worst


def test_rankcount_takes_offset_views_and_refuses_ragged_depth(cuda):
    rng = np.random.RandomState(8)
    q, n, d = 70, 300, 36
    queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda)
    flat = torch.empty(n * d + 1, device=cuda)
    gallery = flat[1:].view(n, d)  # contiguous, 4 bytes off 16-byte alignment
    gallery.copy_(torch.from_numpy(_exact_rows(rng, n, d)))
    pos = queries @ gallery[5]
    want = rankcount_kernel.violation_counts_plain(queries, gallery, pos)
    got = rankcount_kernel.violation_counts(queries, gallery, pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        rankcount_kernel.violation_counts(queries[:, :35].contiguous(),
                                          gallery[:, :35].contiguous(), pos)


def test_encode_on_card_matches_cpu(cuda):
    cfg = ModelConfig(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
                      hierarchical=True, attention_pool=True,
                      bidirectional=False)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randn(6, 3, 7, 20).astype(np.float32))
    frame_len = torch.from_numpy(rng.randint(0, 8, (6, 3)).astype(np.int32))
    clip_len = torch.from_numpy(rng.randint(0, 4, 6).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        model = CMHSE(dataclasses.replace(cfg), 64, device=dev,
                      generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            v, _ = model.encode_video(frames.to(dev), frame_len.to(dev),
                                      clip_len.to(dev))
        out[str(dev)] = v.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-5, rtol=0)


def test_topk_on_card_keeps_lowest_index_ties(cuda):
    rng = np.random.RandomState(2)
    base = np.round(rng.randn(300, 8) * 8) / 8
    base[250] = base[2]
    base[131] = base[130]
    g = torch.from_numpy(base.astype(np.float32)).to(cuda)
    q = torch.from_numpy((np.round(rng.randn(5, 8) * 8) / 8)
                         .astype(np.float32)).to(cuda)
    valid = torch.ones(300, dtype=torch.bool, device=cuda)
    ds, di = dense_sim_topk(q, g, valid, 300)
    ss, si = streaming_sim_topk(q, g, 300, chunk=100)
    assert torch.equal(si, di)
    cpu_s, cpu_i = dense_sim_topk(q.cpu(), g.cpu(), valid.cpu(), 300)
    assert torch.equal(di.cpu(), cpu_i)


# (B, T, H): rows not a multiple of 8; H > 4 * 256 (two unit groups per
# thread); a block whose rows are all past their length for some steps
VARIANT_SHAPES = [(8, 6, 16), (37, 9, 64), (9, 3, 1100), (24, 12, 256)]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,h", VARIANT_SHAPES)
def test_gru_fwd_variants_match_plain(cuda, seeded, b, t, h):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=b * t + h, zero_rows=(0, b - 1))]
    h0 = (torch.randn(b, h, device=cuda) * 0.5) if seeded else None
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=True)
    before = (gru_kernel.save_gates_launches, gru_kernel.with_h0_launches)
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=True)
    torch.cuda.synchronize()
    assert (gru_kernel.save_gates_launches,
            gru_kernel.with_h0_launches) == (before[0] + 1,
                                             before[1] + int(seeded))
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
    torch.testing.assert_close(got[2][live], want[2][live], atol=1e-5,
                               rtol=0)
    if seeded:  # a length-0 row keeps its seed; the unsaved variant agrees
        torch.testing.assert_close(got[1][0], h0[0], atol=0, rtol=0)
        outs, final = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0)
        torch.testing.assert_close(final, want[1], atol=1e-5, rtol=0)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("cotangents", ["both", "final_only"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,h", VARIANT_SHAPES)
def test_gru_bwd_matches_plain(cuda, seeded, cotangents, b, t, h):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=b + 2 * t + h, zero_rows=(0, b - 1))]
    h0 = (torch.randn(b, h, device=cuda) * 0.5) if seeded else None
    outs, _, gates = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0,
                                            save_gates=True)
    douts = (torch.randn(b, t, h, device=cuda) if cotangents == "both"
             else None)
    dfinal = torch.randn(b, h, device=cuda)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
    before = gru_kernel.bwd_launches
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    assert gru_kernel.bwd_launches == before + 1
    # f32 sums over K = 3H in another order, compounded over T steps
    for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= 1e-4, (name, _rel_err(g, w))
    for r in (0, b - 1):  # length-0 rows: pass-through, no gate gradient
        assert not got[0][r].any() and not got[1][r].any()
        pass_through = dfinal[r] + (douts[r].sum(0) if douts is not None
                                    else 0)
        torch.testing.assert_close(got[3][r], pass_through, atol=1e-5,
                                   rtol=1e-5)


def test_trainable_gru_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(4)
    b, t, d, h = 19, 7, 10, 36
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[3] = 0
    params = [(rng.randn(*s) * 0.2).astype(np.float32)
              for s in ((d, 3 * h), (h, 3 * h), (3 * h,), (3 * h,), (b, h))]
    co = rng.randn(b, t, h).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        w_i, w_h, b_i, b_h, h0 = [torch.from_numpy(p).to(dev)
                                  .requires_grad_() for p in params]
        xw = torch.from_numpy(x).to(dev) @ w_i + b_i
        outs, final = gru_kernel.gru_recurrence(
            xw, w_h, b_h, torch.from_numpy(lengths).to(dev), h0)
        ((outs * torch.from_numpy(co).to(dev)).sum()
         + (final ** 2).sum()).backward()
        grads[str(dev)] = [p.grad.cpu() for p in (w_i, w_h, b_i, b_h, h0)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(g, w) <= 1e-4


def _exact_rows_64(rng, n, d):
    return (np.round(rng.randn(n, d) * 8) / 64).astype(np.float32)


# (B, D): one block; a ragged last block of query rows and of column tiles;
# D not a multiple of the 32-deep staging
@pytest.mark.parametrize("b,d", [(16, 32), (300, 64), (64, 1024), (77, 100)])
def test_simhinge_matches_plain_exactly(cuda, b, d):
    rng = np.random.RandomState(b + d)
    a = _exact_rows_64(rng, b, d)
    p = _exact_rows_64(rng, b, d)
    p[5] = p[1]  # duplicate columns: the lowest index must win the tie
    a[b - 1] = a[2]
    neg = rng.rand(b, b) > 0.3
    np.fill_diagonal(neg, False)
    neg[4] = False     # a row with no negative
    neg[:, 6] = False  # a column with no negative
    ta, tp, tneg = [torch.from_numpy(v).to(cuda) for v in (a, p, neg)]
    diag = torch.sum(ta * tp, dim=1)
    for x, y, tr in ((ta, tp, False), (tp, ta, True)):
        want = simhinge_kernel.simhinge_rowpass_plain(x, y, tneg, diag, 0.2,
                                                      tr)
        before = simhinge_kernel.launches
        got = simhinge_kernel.simhinge_rowpass(x, y, tneg, diag, 0.2, tr)
        torch.cuda.synchronize()
        assert simhinge_kernel.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0][6] == simhinge_kernel.NEG_INF  # compared in float32
    assert int(got[1][6]) == 0


def test_fused_loss_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(7)
    b, d = 50, 24
    a = rng.randn(b, d).astype(np.float32)
    p = (a + rng.randn(b, d)).astype(np.float32)
    ids = rng.randint(0, 20, b)
    valid = rng.rand(b) > 0.1
    out = {}
    for dev in ("cpu", cuda):
        ta = torch.from_numpy(a).to(dev).requires_grad_()
        tp = torch.from_numpy(p).to(dev).requires_grad_()
        tid = torch.from_numpy(ids).to(dev)
        loss = simhinge_kernel.fused_contrastive_loss_from_masks(
            ta, tp, 0.2, tid[:, None] == tid[None, :],
            torch.from_numpy(valid).to(dev))
        loss.backward()
        out[str(dev)] = [loss.detach().cpu(), ta.grad.cpu(), tp.grad.cpu()]
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor the GRU Function, the fused loss and the decoder
    (at T < 16 too) raise rather than fall back to a plain version."""
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(4, 3, 6, 0)]
    with pytest.raises(ValueError):  # H not a multiple of 4
        gru_kernel.gru_recurrence(xw, w_h.requires_grad_(), b_h, lengths)
    big = gru_kernel.bwd_max_hidden() + 4
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(2, 2, big, 0)]
    with pytest.raises(ValueError):  # past gru_bwd's shared memory
        gru_kernel.gru_recurrence(xw, w_h.requires_grad_(), b_h, lengths)
    a = torch.randn(8, 4096, device=cuda)  # rows past its shared memory
    with pytest.raises(ValueError):
        simhinge_kernel.fused_contrastive_loss_from_masks(a, a)
    dec = ReconstructionDecoder(6, 6).to(cuda)  # H = 6, T = 4 < 16
    with pytest.raises(ValueError):
        dec(torch.randn(3, 6, device=cuda), torch.randn(3, 4, 6, device=cuda),
            torch.full((3,), 4, dtype=torch.int32, device=cuda))


def test_train_step_on_card_matches_cpu(cuda):
    cfg = ModelConfig(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
                      hierarchical=True, attention_pool=True,
                      reconstruction=True)
    rng = np.random.RandomState(1)
    batch = Batch(frames=rng.randn(6, 3, 7, 20).astype(np.float32),
                  frame_len=rng.randint(0, 8, (6, 3)).astype(np.int32),
                  clip_len=rng.randint(1, 4, 6).astype(np.int32),
                  words=rng.randint(0, 64, (6, 3, 5)).astype(np.int32),
                  word_len=rng.randint(0, 6, (6, 3)).astype(np.int32),
                  sent_len=rng.randint(1, 4, 6).astype(np.int32),
                  video_ids=np.arange(6, dtype=np.int32),
                  valid=np.array([1, 1, 1, 1, 1, 0], bool))
    exp = ExperimentConfig(model=cfg)
    grads, metrics = {}, {}
    for dev in ("cpu", cuda):
        model = CMHSE(cfg, 64, device=dev,
                      generator=torch.Generator().manual_seed(3))
        b = batch.to(dev)
        loss, m = total_loss(model(b), b, exp.loss)
        loss.backward()
        grads[str(dev)] = {k: p.grad.cpu() for k, p in
                           model.named_parameters()}
        state, m = train_step(create_train_state(exp, model), batch,
                              exp.loss)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
    for k, g in grads["cuda"].items():
        assert _rel_err(g, grads["cpu"][k]) <= 1e-4, k
    for k, v in metrics["cuda"].items():
        assert abs(v - metrics["cpu"][k]) <= 1e-4 * abs(metrics["cpu"][k]), k
