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
from cmhse_tpu_torch.ops import (cuda_lib, gru_kernel, rankcount_kernel,
                                 simhinge_kernel)
from cmhse_tpu_torch.train import create_train_state, total_loss, train_step
from cmhse_tpu_torch.ops.topk import (dense_sim_topk, int8_product,
                                      prepare_topk_gallery,
                                      quantized_sim_topk, streaming_sim_topk)

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


# (B, T, H): tiny; rows not a multiple of 32; H = 1100 (9 units a block on
# 132 SMs: a second pass of one unit); a wider H
@pytest.mark.parametrize("b,t,h", [(8, 6, 16), (37, 9, 64), (9, 3, 1100),
                                   (24, 12, 256)])
def test_gru_fwd_matches_plain(cuda, b, t, h):
    args = _gru_inputs(b, t, h, seed=b + t + h, zero_rows=(0, b - 1))
    want_outs, want_final = gru_kernel.gru_recurrence_plain(
        *[a.to(cuda) for a in args])
    cuda_lib.reset_launches()
    outs, final = gru_kernel.gru_recurrence(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert cuda_lib.launches == {("gru_fwd", "float32", "encode"): 1}
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
    cuda_lib.reset_launches()
    outs, _ = gru_kernel.gru_recurrence(xw, w_h.requires_grad_(), b_h,
                                        lengths)
    assert type(outs.grad_fn).__name__ == "TrainableGRUBackward"
    assert cuda_lib.launches == {("gru_fwd", "float32", "save_gates"): 1}
    # H not a multiple of 4 is padded, not refused
    xw6, w_h6, b_h6, lengths6 = [a.to(cuda) for a in _gru_inputs(4, 3, 6, 0)]
    got = gru_kernel.gru_recurrence(xw6, w_h6, b_h6, lengths6)
    want = gru_kernel.gru_recurrence_plain(xw6, w_h6, b_h6, lengths6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


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


# one query (cuBLASLt's int8 product wants more than 16 rows), D not a
# multiple of 8 (its K), and a block past both
@pytest.mark.parametrize("q_rows,d", [(1, 16), (3, 20), (40, 64)])
def test_int8_topk_on_card_matches_cpu(cuda, q_rows, d):
    """The int8 path on the card: the int8 rows and scales equal the CPU's
    bit for bit, ``int8_product`` equals the int32 product, and the int8
    and the exact grouped scans return the CPU's indices."""
    rng = np.random.RandomState(q_rows + d)
    g = rng.randn(6000, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:q_rows] + 0.01 * rng.randn(q_rows, d).astype(np.float32)
    valid = rng.rand(6000) > 0.1
    cpu = prepare_topk_gallery(torch.from_numpy(g), torch.from_numpy(valid),
                               chunk=3000, quantize=True)
    card = prepare_topk_gallery(torch.from_numpy(g).to(cuda),
                                torch.from_numpy(valid).to(cuda),
                                chunk=3000, quantize=True)
    assert torch.equal(card.int8_chunks.cpu(), cpu.int8_chunks)
    assert torch.equal(card.int8_scale.cpu(), cpu.int8_scale)
    a, b = card.int8_chunks[0, :q_rows], card.int8_chunks[1]
    assert torch.equal(int8_product(a, b).cpu(),
                       a.cpu().int() @ b.cpu().int().T)
    for search in (lambda p, x: quantized_sim_topk(x, p, 5, rescore_m=16),
                   lambda p, x: streaming_sim_topk(x, p, 5)):
        _, want = search(cpu, torch.from_numpy(q))
        _, got = search(card, torch.from_numpy(q).to(cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("quantize", [False, True])
def test_retriever_local_mesh_on_card_matches_one_device(cuda, quantize):
    """``Retriever(mesh=)`` over a local mesh of 4 shards on cuda:0, held
    prepared (40,000 rows, past the size rule), against the single-device
    Retriever after a build, an add (the shards rebuilt), a remove and a
    compaction. The rows lie on a 1/64 grid at D = 64, so every product is
    exact in f32 whatever the split: the exact top-k equal, ties included;
    the int8 one captures at least 0.99 of it."""
    from cmhse_tpu_torch.eval.serve import Retriever
    from cmhse_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(12)

    def rows(n):
        return torch.from_numpy((np.round(rng.randn(n, 64) * 8) / 64.0)
                                .astype(np.float32)).to(cuda)

    n, extra = 40_000, 3_000
    g, q = rows(n), rows(24)
    valid = torch.from_numpy(rng.rand(n) > 0.05).to(cuda)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    one = Retriever(None)
    sharded = Retriever(None, mesh=mesh, quantize=quantize)
    new = rows(extra)
    drop = rng.choice(n, 400, replace=False).tolist()
    for stage in ("build", "add", "remove", "compact"):
        for r in (one, sharded):
            if stage == "build":
                r.build_gallery(encoded=(g, g, valid, np.arange(n)))
            elif stage == "add":
                r.add_to_gallery(encoded=(new, new, torch.ones(
                    extra, dtype=torch.bool, device=cuda),
                    np.arange(n, n + extra)))
            elif stage == "remove":
                assert r.remove_from_gallery(drop) == int(
                    valid[drop].sum())
            else:
                r.compact()
        assert len(sharded._prepared) == 4
        assert all(p.chunks.device.type == "cuda" for p in sharded._prepared)
        want_s, want_i = one._search(q, 10)
        got_s, got_i = sharded._search(q, 10)
        if quantize:
            capture = (got_i[:, :, None] == want_i[:, None, :]).any(2).mean()
            assert capture >= 0.99, (stage, capture)
        else:
            np.testing.assert_array_equal(got_i, want_i, err_msg=stage)
            np.testing.assert_array_equal(got_s, want_s, err_msg=stage)


# (B, T, H): rows not a multiple of 32; H = 1100 (a second pass of units);
# steps at which every row is past its length
VARIANT_SHAPES = [(8, 6, 16), (37, 9, 64), (9, 3, 1100), (24, 12, 256)]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,h", VARIANT_SHAPES)
def test_gru_fwd_variants_match_plain(cuda, seeded, b, t, h):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=b * t + h, zero_rows=(0, b - 1))]
    h0 = (torch.randn(b, h, device=cuda) * 0.5) if seeded else None
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=True)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=True)
    torch.cuda.synchronize()
    variant = "save_gates+with_h0" if seeded else "save_gates"
    assert cuda_lib.launches == {("gru_fwd", "float32", variant): 1}
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
    cuda_lib.reset_launches()
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    variant = "with_h0" if seeded else "zero_h0"
    assert cuda_lib.launches == {("gru_bwd", "float32", variant): 1}
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


# (M, N, D): one partial tile; one tile; 16 x 16 tiles (the training
# shape); a ragged 100 x 37 that fills no tile; D = 300, not a multiple of
# the 32-deep slab; D = 30, not a multiple of 4 (padded with zeros)
@pytest.mark.parametrize("m,n,d", [(1, 1, 32), (64, 64, 1024),
                                   (512, 512, 1024), (100, 37, 64),
                                   (77, 77, 300), (50, 40, 30)])
def test_simhinge_matches_plain_exactly(cuda, m, n, d):
    rng = np.random.RandomState(m + n + d)
    a = _exact_rows_64(rng, m, d)
    p = _exact_rows_64(rng, n, d)
    neg = rng.rand(m, n) > 0.3
    ties = m >= 8 and n >= 8
    if ties:
        # row 2's best negatives: columns 1 and 5, equal and longest
        p[1] *= 8
        p[5] = p[1]
        a[2] = p[1]
        neg[2, [1, 5]] = True
        neg[2, 3] = False
        # column 3's best negatives: rows 0 and 6, equal and longest
        a[0] *= 4
        a[6] = a[0]
        p[3] = a[0]
        neg[[0, 6], 3] = True
        neg[4] = False     # a row with no negative
        neg[:, 7] = False  # a column with no negative
    ta, tp, tneg = [torch.from_numpy(v).to(cuda) for v in (a, p, neg)]
    row_diag = torch.from_numpy((rng.randint(-64, 64, m) / 16)
                                .astype(np.float32)).to(cuda)
    col_diag = torch.from_numpy((rng.randint(-64, 64, n) / 16)
                                .astype(np.float32)).to(cuda)
    want = simhinge_kernel.simhinge_pair_plain(ta, tp, tneg, row_diag,
                                               col_diag, 0.2)
    cuda_lib.reset_launches()
    got = simhinge_kernel.simhinge_pair(ta, tp, tneg, row_diag, col_diag,
                                        0.2)
    torch.cuda.synchronize()
    assert cuda_lib.launches == {("simhinge", "float32", "pair"): 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if ties:
        assert int(got[1][2]) == 1 and int(got[3][3]) == 0
        assert got[0][4] == simhinge_kernel.NEG_INF and int(got[1][4]) == 0
        assert got[2][7] == simhinge_kernel.NEG_INF and int(got[3][7]) == 0


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
    (at T < 16 too) raise on what they cannot take rather than fall back
    to a plain version; an H not a multiple of 4, or past the resident
    W_h limit, is no longer such a case: it runs the kernels."""
    for h in (6, gru_kernel.bwd_max_hidden() + 4):
        xw, w_h, b_h, lengths = [a.to(cuda)
                                 for a in _gru_inputs(2, 2, h, 0)]
        cuda_lib.reset_launches()
        outs, final = gru_kernel.gru_recurrence(xw, w_h.requires_grad_(),
                                                b_h, lengths)
        (outs.sum() + final.sum()).backward()
        assert cuda_lib.launch_count("gru_fwd") == 1
        assert cuda_lib.launch_count("gru_bwd") == 1
        assert torch.isfinite(w_h.grad).all()
    with pytest.raises(TypeError):  # f64: no cast behind the caller
        gru_kernel.gru_recurrence(xw.double(), w_h.double(), b_h, lengths)
    a = torch.randn(8, 4096, device=cuda)
    with pytest.raises(TypeError):  # f64 rows: no cast behind the caller
        simhinge_kernel.simhinge_pair(a.double(), a.double(),
                                      torch.ones(8, 8, dtype=torch.bool,
                                                 device=cuda), a[:, 0],
                                      a[:, 0], 0.2)
    # no depth limit: only slabs of the rows are staged
    loss = simhinge_kernel.fused_contrastive_loss_from_masks(a, a)
    want = simhinge_kernel.fused_contrastive_loss_from_masks(a.cpu(), a.cpu())
    torch.testing.assert_close(loss.cpu(), want, atol=1e-4, rtol=1e-5)
    dec = ReconstructionDecoder(6, 6).to(cuda)  # H = 6, T = 4 < 16
    args = (torch.randn(3, 6), torch.randn(3, 4, 6),
            torch.full((3,), 4, dtype=torch.int32))
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = dec(*[x.to(cuda) for x in args])
        want = dec.to("cpu")(*args)
    assert cuda_lib.launch_count("gru_fwd") == 1  # the kernel, padded
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


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
        cuda_lib.reset_launches()
        loss, m = total_loss(model(b), b, exp.loss)
        loss.backward()
        assert cuda_lib.launches == ({} if dev == "cpu" else {
            ("gru_fwd", "float32", "save_gates"): 4,
            ("gru_fwd", "float32", "save_gates+with_h0"): 2,
            ("gru_bwd", "float32", "zero_h0"): 4,
            ("gru_bwd", "float32", "with_h0"): 2,
            ("simhinge", "float32", "pair"): 2})
        grads[str(dev)] = {k: p.grad.cpu() for k, p in
                           model.named_parameters()}
        state, m = train_step(create_train_state(exp, model), batch,
                              exp.loss)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
    for k, g in grads["cuda"].items():
        assert _rel_err(g, grads["cpu"][k]) <= 1e-4, k
    for k, v in metrics["cuda"].items():
        assert abs(v - metrics["cpu"][k]) <= 1e-4 * abs(metrics["cpu"][k]), k


# ---- bf16 (the mixed-precision configuration) ------------------------------
# Each bf16 kernel against its plain version on the card, compared in bf16:
# outputs within atol 1e-2 and gradients within relative L2 2e-2, the JAX
# package's own bf16 bands (tests/test_pallas_gru.py,
# tests/test_pallas_gru_grad.py). The two sum in other orders, and a last-bit
# difference in the f32 carry can move the bf16 operand of the next step's
# product by an ulp.

BF16 = torch.bfloat16
BF16_ATOL = 1e-2
BF16_GRAD_RL2 = 2e-2

# (B, T, H): rows not a multiple of 32; T = 1 at H = 1024; H = 1100 (a
# second pass of units, H not a multiple of 8) with zero-length rows
BF16_SHAPES = [(8, 6, 16), (37, 9, 64), (9, 1, 1024), (21, 7, 1100)]


def _bf16_gru_inputs(b, t, h, seed, cuda):
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed, zero_rows=(0, b - 1))]
    h0 = (torch.randn(b, h, device=cuda) * 0.5).to(BF16)
    return xw.to(BF16), w_h.to(BF16), b_h, lengths, h0


def _rel_l2(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


@pytest.mark.parametrize("variant", ["encode", "save_gates", "save_gates_h0"])
@pytest.mark.parametrize("b,t,h", BF16_SHAPES)
def test_gru_fwd_bf16_matches_plain(cuda, variant, b, t, h):
    xw, w_h, b_h, lengths, h0 = _bf16_gru_inputs(b, t, h, b * t + h, cuda)
    save = variant != "encode"
    h0 = h0 if variant == "save_gates_h0" else None
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=save)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=save)
    torch.cuda.synchronize()
    # the bf16 instantiation, not the f32 one
    name = {"save_gates_h0": "save_gates+with_h0"}.get(variant, variant)
    assert cuda_lib.launches == {("gru_fwd", "bfloat16", name): 1}
    assert all(g.dtype == BF16 for g in got)
    torch.testing.assert_close(got[0], want[0], atol=BF16_ATOL, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=BF16_ATOL, rtol=0)
    if save:
        live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
        torch.testing.assert_close(got[2][live], want[2][live],
                                   atol=BF16_ATOL, rtol=0)
    start = h0[0] if h0 is not None else torch.zeros_like(got[1][0])
    assert torch.equal(got[1][0], start)  # a length-0 row keeps its start


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,h", BF16_SHAPES)
def test_gru_bwd_bf16_matches_plain(cuda, seeded, b, t, h):
    xw, w_h, b_h, lengths, h0 = _bf16_gru_inputs(b, t, h, b + 2 * t + h,
                                                 cuda)
    h0 = h0 if seeded else None
    outs, _, gates = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0,
                                            save_gates=True)
    douts = torch.randn(b, t, h, device=cuda).to(BF16)
    dfinal = torch.randn(b, h, device=cuda).to(BF16)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    variant = "with_h0" if seeded else "zero_h0"
    assert cuda_lib.launches == {("gru_bwd", "bfloat16", variant): 1}
    assert [g.dtype for g in got] == [BF16, BF16, torch.float32, BF16]
    for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _rel_l2(g, w) <= BF16_GRAD_RL2, (name, _rel_l2(g, w))
    for r in (0, b - 1):  # length-0 rows: no gate gradient
        assert not got[0][r].any() and not got[1][r].any()


# The shapes the cooperative gru_fwd makes edges of, (B, T, H, all lengths
# 0): H not a multiple of 8 units times the blocks (the last block owns 4);
# H = 32, four blocks of 8 units; B = 1 (one warp's rows); B = 513 (a
# third chunk of one row); every length 0; T = 1. "max" is
# fwd_max_hidden() of the type.
COOP_SHAPES = {"h1028": (9, 5, 1028, False), "h32": (8, 6, 32, False),
               "hmax": (4, 3, "max", False), "b1": (1, 7, 64, False),
               "b513": (513, 4, 64, False), "len0": (20, 5, 64, True),
               "t1": (37, 1, 256, False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["encode", "save_gates", "save_gates_h0"])
@pytest.mark.parametrize("shape", sorted(COOP_SHAPES))
def test_gru_fwd_cooperative_edges(cuda, dtype, variant, shape):
    dt = getattr(torch, dtype)
    b, t, h, no_len = COOP_SHAPES[shape]
    if h == "max":
        h = gru_kernel.fwd_max_hidden(dt)
        assert h >= 1024  # every configuration of the repo has H = 1024
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=b + t + h, zero_rows=(0,))]
    if no_len:
        lengths.zero_()
    xw, w_h = xw.to(dt), w_h.to(dt)
    save = variant != "encode"
    h0 = ((torch.randn(b, h, device=cuda) * 0.5).to(dt)
          if variant == "save_gates_h0" else None)
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=save)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=save)
    torch.cuda.synchronize()
    name = {"save_gates_h0": "save_gates+with_h0"}.get(variant, variant)
    assert cuda_lib.launches == {("gru_fwd", dtype, name): 1}
    atol = 1e-5 if dt == torch.float32 else BF16_ATOL
    torch.testing.assert_close(got[0], want[0], atol=atol, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=atol, rtol=0)
    if save:
        live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
        torch.testing.assert_close(got[2][live], want[2][live], atol=atol,
                                   rtol=0)
    start = h0[0] if h0 is not None else torch.zeros_like(got[1][0])
    assert torch.equal(got[1][0], start)  # a length-0 row keeps its start


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_fwd_refuses_past_max_hidden(cuda, dtype):
    """Past the resident W_h limit gru_fwd no longer refuses: it launches
    its streamed variant, once, and agrees with the plain version."""
    dt = getattr(torch, dtype)
    h = gru_kernel.fwd_max_hidden(dt) + 4
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(2, 2, h, 0)]
    xw, w_h = xw.to(dt), w_h.to(dt)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths)
    torch.cuda.synchronize()
    assert cuda_lib.launches == {("gru_fwd", dtype, "encode+streamed"): 1}
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths)
    atol = 1e-5 if dt == torch.float32 else BF16_ATOL
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_fwd_is_bitwise_repeatable(cuda, dtype):
    """No atomics: the sums run in a fixed order, so two runs of a 512 x 64
    call at H = 1024 give the same bits."""
    dt = getattr(torch, dtype)
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(512, 64, 1024,
                                                             11)]
    xw, w_h = xw.to(dt), w_h.to(dt)
    first = gru_kernel.gru_forward(xw, w_h, b_h, lengths, save_gates=True)
    second = gru_kernel.gru_forward(xw, w_h, b_h, lengths, save_gates=True)
    live = (torch.arange(64, device=cuda)[None, :] < lengths[:, None])
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2][live], second[2][live])


# The shapes the cooperative gru_bwd makes edges of, (B, T, H, lengths):
# H = 1028, not a multiple of 8 (the last block owns 4 units; bf16 stages
# through registers, and a 64-depth slab straddles 2H); H = 32, four blocks;
# "max" is bwd_max_hidden() of the type (a second pass of units); B = 1;
# B = 513 (f32: five chunks of live rows, bf16: three); every length 0;
# T = 1; lengths with ties; lengths past T. The lengths are in no row order.
BWD_SHAPES = {"h1028": (9, 5, 1028, "random"), "h32": (8, 6, 32, "random"),
              "hmax": (4, 3, "max", "random"), "b1": (1, 7, 64, "random"),
              "b513": (513, 4, 64, "random"), "len0": (20, 5, 64, "zero"),
              "t1": (37, 1, 256, "random"), "ties": (40, 6, 64, "ties"),
              "past_t": (12, 5, 64, "past_t")}


def _bwd_lengths(kind, b, t, lengths):
    if kind == "zero":
        return torch.zeros_like(lengths)
    if kind == "ties":  # lengths 0, t // 2 and t, in turn
        return (torch.arange(b, device=lengths.device, dtype=torch.int32)
                % 3) * (t // 2)
    if kind == "past_t":  # some rows longer than the call
        return lengths * 2
    return lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("cotangents", ["both", "final_only"])
@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_gru_bwd_cooperative_edges(cuda, dtype, seeded, cotangents, shape):
    """One cooperative launch against the plain BPTT loop, in today's
    bands: f32 max abs error within 1e-4 of the largest reference entry,
    bf16 relative L2 within 2e-2; length-0 rows emit zeros."""
    dt = getattr(torch, dtype)
    b, t, h, kind = BWD_SHAPES[shape]
    if h == "max":
        h = gru_kernel.bwd_max_hidden(dt)
        assert h >= 1100  # above every configuration's H = 1024
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=b + 3 * t + h)]
    lengths = _bwd_lengths(kind, b, t, lengths)
    xw, w_h = xw.to(dt), w_h.to(dt)
    gen = torch.Generator(device=cuda).manual_seed(b + t + h)
    h0 = ((torch.randn(b, h, device=cuda, generator=gen) * 0.5).to(dt)
          if seeded else None)
    # the plain forward: "max" may lie past gru_fwd's own bound
    outs, _, gates = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths,
                                                     h0, save_gates=True)
    douts = (torch.randn(b, t, h, device=cuda, generator=gen).to(dt)
             if cotangents == "both" else None)
    dfinal = torch.randn(b, h, device=cuda, generator=gen).to(dt)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    variant = "with_h0" if seeded else "zero_h0"
    assert cuda_lib.launches == {("gru_bwd", dtype, variant): 1}
    assert [g.dtype for g in got] == [dt, dt, torch.float32, dt]
    for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
        assert torch.isfinite(g.float()).all(), name
        err = (_rel_err(g.float(), w.float()) if dt == torch.float32
               else _rel_l2(g, w))
        assert err <= (1e-4 if dt == torch.float32 else BF16_GRAD_RL2), (
            name, err)
    dead = (lengths == 0).nonzero().flatten()
    assert not got[0][dead].any() and not got[1][dead].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_bwd_refuses_past_max_hidden(cuda, dtype):
    """Past the resident W_h limit gru_backward takes its streamed variant;
    what it still refuses is an H past 256 units a block on one block an
    SM (its gate pass takes a unit a thread), before any launch."""
    dt = getattr(torch, dtype)
    b, t = 2, 2
    lengths = torch.full((b,), t, dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    h = 256 * sms + 4
    gates = torch.zeros(b, t, 4 * h, dtype=dt, device=cuda)
    outs = torch.zeros(b, t, h, dtype=dt, device=cuda)
    w_h = torch.empty(h, 3 * h, dtype=dt, device=cuda)  # never read
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="256 units a block"):
        gru_kernel.gru_backward(gates, outs, lengths, w_h)
    assert not cuda_lib.launches
    del w_h
    h = gru_kernel.bwd_max_hidden(dt) + 4
    gates = torch.zeros(b, t, 4 * h, dtype=dt, device=cuda)
    outs = torch.zeros(b, t, h, dtype=dt, device=cuda)
    w_h = torch.zeros(h, 3 * h, dtype=dt, device=cuda)
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h)
    assert cuda_lib.launches == {("gru_bwd", dtype, "zero_h0+streamed"): 1}
    assert all(not g.any() for g in got)  # zero cotangents, zero gradients


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_bwd_is_bitwise_repeatable(cuda, dtype):
    """No float atomics and sums in a fixed order: two runs of a 512 x 64
    call at H = 1024 give the same bits in dxw, dhn, db and dh0."""
    dt = getattr(torch, dtype)
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(512, 64, 1024,
                                                             12)]
    xw, w_h = xw.to(dt), w_h.to(dt)
    outs, _, gates = gru_kernel.gru_forward(xw, w_h, b_h, lengths,
                                            save_gates=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    douts = torch.randn(512, 64, 1024, device=cuda, generator=gen).to(dt)
    dfinal = torch.randn(512, 1024, device=cuda, generator=gen).to(dt)
    first = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal)
    second = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts,
                                     dfinal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_kernels_take_no_mixed_types(cuda):
    """A bf16 stream with an f32 W_h (or cotangent) raises: nothing is cast
    up or down behind the caller's back, and no f32 kernel runs."""
    xw, w_h, b_h, lengths, h0 = _bf16_gru_inputs(6, 4, 8, 5, cuda)
    cuda_lib.reset_launches()
    with pytest.raises(TypeError):
        gru_kernel.gru_forward(xw, w_h.float(), b_h, lengths)
    with pytest.raises(TypeError):
        gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0.float())
    with pytest.raises(TypeError):  # b_h stays f32
        gru_kernel.gru_forward(xw, w_h, b_h.to(BF16), lengths)
    outs, _, gates = gru_kernel.gru_forward(xw, w_h, b_h, lengths,
                                            save_gates=True)
    with pytest.raises(TypeError):
        gru_kernel.gru_backward(gates, outs, lengths, w_h,
                                torch.randn_like(outs.float()))
    with pytest.raises(TypeError):
        gru_kernel.gru_forward(xw.half(), w_h.half(), b_h, lengths)
    assert cuda_lib.launches == {("gru_fwd", "bfloat16", "save_gates"): 1}


@pytest.mark.parametrize("q,n,d", [(64, 256, 32), (130, 1000, 100)])
def test_rankcount_lowp_matches_plain_exactly(cuda, q, n, d):
    """precision="bfloat16" rounds both operands to bf16; on rows whose
    rounded products sum exactly in f32 the counts must be equal. A
    perturbation below bf16's resolution counts in f32 and not in lowp."""
    rng = np.random.RandomState(q + n + 1)
    queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda)
    gallery = torch.from_numpy(_exact_rows(rng, n, d)).to(cuda)
    pos_idx = torch.from_numpy(rng.randint(0, n, q)).to(cuda)
    pos = (queries * gallery[pos_idx]).sum(1)
    pos[3] = float("nan")
    valid = torch.from_numpy(rng.rand(n) > 0.2).to(cuda)
    for gv, pi in ((None, None), (valid, pos_idx)):
        want = rankcount_kernel.violation_counts_plain(
            queries, gallery, pos, gv, pi, precision="bfloat16")
        cuda_lib.reset_launches()
        got = rankcount_kernel.violation_counts(queries, gallery, pos, gv, pi,
                                                precision="bfloat16")
        torch.cuda.synchronize()
        assert cuda_lib.launches == {("rankcount", "bfloat16", "lowp"): 1}
        assert torch.equal(got, want)
    # below bf16's resolution: invisible to lowp, seen by the f32 branch
    g_int = torch.from_numpy(rng.randint(-3, 4, (n, d)).astype(np.float32))
    q_int = torch.from_numpy(rng.randint(-3, 4, (q, d)).astype(np.float32))
    pos_int = (q_int * g_int[pos_idx.cpu()]).sum(1)
    g_pert = (g_int + torch.rand(n, d) * 2**-12 * (g_int != 0)).to(cuda)
    args = (q_int.to(cuda), g_pert, pos_int.to(cuda), None, pos_idx)
    lowp = rankcount_kernel.violation_counts(*args, precision="bfloat16")
    exact = rankcount_kernel.violation_counts_plain(
        q_int.to(cuda), g_int.to(cuda), pos_int.to(cuda), None, pos_idx)
    assert torch.equal(lowp, exact)
    assert not torch.equal(rankcount_kernel.violation_counts(*args), exact)


# ---- rankcount at the edges of its tiles (both branches) -------------------
# Tiles are 128 queries x 256 gallery rows (lowp: 64 queries a warpgroup;
# f32: 128 gallery rows where 256-row tiles would leave an SM without a
# block, as at these small shapes), with 32-deep (f32) and 64-deep (lowp)
# slabs; the shapes straddle them.

RC_PRECISIONS = ("float32", "bfloat16")


def _rankcount_case(cuda, q, n, d, seed, precision, masks=True):
    """Exact rows, a NaN positive and (with ``masks``) holes in the gallery
    and pos_idx: the kernel's counts must equal the plain version's, in one
    launch."""
    rng = np.random.RandomState(seed)
    queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda)
    gallery = torch.from_numpy(_exact_rows(rng, n, d)).to(cuda)
    pos_idx = torch.from_numpy(rng.randint(0, n, q)).to(cuda)
    pos = (queries * gallery[pos_idx]).sum(1)
    pos[q // 2] = float("nan")
    valid = torch.from_numpy(rng.rand(n) > 0.2).to(cuda)
    gv, pi = (valid, pos_idx) if masks else (None, None)
    want = rankcount_kernel.violation_counts_plain(queries, gallery, pos, gv,
                                                   pi, precision=precision)
    cuda_lib.reset_launches()
    got = rankcount_kernel.violation_counts(queries, gallery, pos, gv, pi,
                                            precision=precision)
    torch.cuda.synchronize()
    variant = "lowp" if precision == "bfloat16" else "f32"
    assert cuda_lib.launches == {("rankcount", precision, variant): 1}
    assert torch.equal(got, want)
    assert int(got[q // 2]) == 0  # a NaN positive counts nothing
    return got


@pytest.mark.parametrize("precision", RC_PRECISIONS)
@pytest.mark.parametrize("q", [1, 63, 64, 65, 129, 257])
def test_rankcount_query_edges(cuda, precision, q):
    _rankcount_case(cuda, q, 300, 36, q, precision)


# smaller than one tile; one short of a tile; one past a tile
@pytest.mark.parametrize("precision", RC_PRECISIONS)
@pytest.mark.parametrize("n", [100, 255, 257])
def test_rankcount_gallery_edges(cuda, precision, n):
    _rankcount_case(cuda, 70, n, 36, n, precision)


# D = 4, 36 and 100 are not multiples of 8 (lowp pads them); 36, 100 and
# 1028 end in a ragged slab in both branches
@pytest.mark.parametrize("precision", RC_PRECISIONS)
@pytest.mark.parametrize("d", [4, 36, 100, 1028])
def test_rankcount_depth_edges(cuda, precision, d):
    for masks in (False, True):
        _rankcount_case(cuda, 65, 257, d, d, precision, masks)


@pytest.mark.parametrize("precision", RC_PRECISIONS)
def test_rankcount_wide_tiles_at_ragged_edges(cuda, precision):
    """Enough 256-row gallery tiles for every SM (the f32 branch's wide
    tiles), with Q, N and D all ragged."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 256 * (sms // 2 + 1) + 1  # two query tiles x this many: >= sms
    _rankcount_case(cuda, 129, n, 100, 3, precision)


@pytest.mark.parametrize("precision", RC_PRECISIONS)
def test_rankcount_masks_and_ties(cuda, precision):
    """An all-invalid gallery counts nothing; pos_idx out of range excludes
    nothing; rows that tie the positive exactly never count (strictly
    greater), also duplicates of the positive's own row."""
    rng = np.random.RandomState(5)
    q, n, d = 70, 300, 64
    queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda)
    gallery = torch.from_numpy(_exact_rows(rng, n, d)).to(cuda)
    pos_idx = torch.from_numpy(rng.randint(0, n, q)).to(cuda)
    gallery[[7, 150, 299]] = gallery[pos_idx[0]].clone()  # ties, query 0
    gallery[[8, 260]] = queries[1]  # rows that score |q_1|^2 for query 1
    # the positive scores in the branch's own arithmetic (exact sums)
    r = ((lambda x: x.to(BF16).float()) if precision == "bfloat16"
         else (lambda x: x))
    pos = (r(queries) * r(gallery)[pos_idx]).sum(1)
    pos[1] = (r(queries[1]) * r(queries[1])).sum()  # query 1's ties
    kw = dict(precision=precision)
    none = torch.zeros(n, dtype=torch.bool, device=cuda)
    got = rankcount_kernel.violation_counts(queries, gallery, pos, none,
                                            pos_idx, **kw)
    assert int(got.abs().sum()) == 0
    out_of_range = pos_idx.clone()
    out_of_range[::3] = -1
    out_of_range[1::3] = n + 5
    for pi in (pos_idx, out_of_range):
        want = rankcount_kernel.violation_counts_plain(queries, gallery, pos,
                                                       None, pi, **kw)
        got = rankcount_kernel.violation_counts(queries, gallery, pos, None,
                                                pi, **kw)
        assert torch.equal(got, want)
    # just below the positive the ties count: they are there
    got = rankcount_kernel.violation_counts(queries, gallery, pos, None,
                                            pos_idx, **kw)
    below = rankcount_kernel.violation_counts(queries, gallery,
                                              pos - 2.0**-20, None, pos_idx,
                                              **kw)
    for i, rows in ((0, {7, 150, 299}), (1, {8, 260})):
        ties = len(rows - {int(pos_idx[i])})  # the positive's own row: out
        assert int(below[i]) >= int(got[i]) + ties


def test_rankcount_lowp_takes_bf16_operands(cuda):
    """bf16 queries and gallery, read as they are (also a D that is not a
    multiple of 8, and an offset view), count the same as their f32
    copies, in one launch each."""
    rng = np.random.RandomState(9)
    for q, n, d in ((65, 257, 64), (70, 300, 36), (130, 1000, 100)):
        queries = torch.from_numpy(_exact_rows(rng, q, d)).to(cuda).to(BF16)
        gallery = torch.from_numpy(_exact_rows(rng, n, d)).to(cuda).to(BF16)
        pos_idx = torch.from_numpy(rng.randint(0, n, q)).to(cuda)
        pos = (queries.float() * gallery[pos_idx].float()).sum(1)
        valid = torch.from_numpy(rng.rand(n) > 0.2).to(cuda)
        flat = torch.empty(n * d + 1, dtype=BF16, device=cuda)
        offset = flat[1:].view(n, d)  # 2 bytes off 16-byte alignment
        offset.copy_(gallery)
        want = rankcount_kernel.violation_counts(
            queries.float(), gallery.float(), pos, valid, pos_idx,
            precision="bfloat16")
        for g in (gallery, offset):
            cuda_lib.reset_launches()
            got = rankcount_kernel.violation_counts(
                queries, g, pos, valid, pos_idx, precision="bfloat16")
            torch.cuda.synchronize()
            assert cuda_lib.launches == {("rankcount", "bfloat16", "lowp"): 1}
            assert torch.equal(got, want)
    with pytest.raises(TypeError):  # the f32 branch takes f32 only
        rankcount_kernel.violation_counts(queries, gallery, pos)
    with pytest.raises(TypeError):
        rankcount_kernel.violation_counts(queries.half(), gallery.half(), pos,
                                          precision="bfloat16")


@pytest.mark.parametrize("precision", RC_PRECISIONS)
def test_rankcount_is_bitwise_repeatable(cuda, precision):
    """Two runs at the serving shape (Q=1024, N=100,000, D=1024) give the
    same counts, equal to the plain version's on exact rows."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def rows(n, d):
        x = torch.randn(n, d, device=cuda, generator=gen)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return torch.round(x * 1024) / 1024

    q, n, d = 1024, 100_000, 1024
    queries, gallery = rows(q, d), rows(n, d)
    pos_idx = torch.randint(0, n, (q,), device=cuda, generator=gen)
    valid = torch.rand(n, device=cuda, generator=gen) > 0.03
    pos = (queries * gallery[pos_idx]).sum(1)
    args = (queries, gallery, pos, valid, pos_idx)
    first = rankcount_kernel.violation_counts(*args, precision=precision)
    second = rankcount_kernel.violation_counts(*args, precision=precision)
    assert torch.equal(first, second)
    want = rankcount_kernel.violation_counts_plain(*args, precision=precision)
    assert torch.equal(first, want)


def _bf16_batch():
    rng = np.random.RandomState(1)
    frames = torch.from_numpy(rng.randn(6, 3, 7, 20).astype(np.float32))
    return Batch(frames=frames.to(BF16),
                 frame_len=rng.randint(0, 8, (6, 3)).astype(np.int32),
                 clip_len=rng.randint(1, 4, 6).astype(np.int32),
                 words=rng.randint(0, 64, (6, 3, 5)).astype(np.int32),
                 word_len=rng.randint(0, 6, (6, 3)).astype(np.int32),
                 sent_len=rng.randint(1, 4, 6).astype(np.int32),
                 video_ids=np.arange(6, dtype=np.int32),
                 valid=np.array([1, 1, 1, 1, 1, 0], bool))


BF16_CFG = ModelConfig(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
                       hierarchical=True, attention_pool=True,
                       reconstruction=True, dtype="bfloat16")


def test_bf16_encode_on_card_matches_cpu(cuda):
    batch = _bf16_batch()
    out = {}
    for dev in ("cpu", cuda):
        model = CMHSE(BF16_CFG, 64, device=dev,
                      generator=torch.Generator().manual_seed(3))
        b = batch.to(dev)
        with torch.inference_mode():
            v, clip = model.encode_video(b.frames, b.frame_len, b.clip_len)
            p, sent = model.encode_text(b.words, b.word_len, b.sent_len)
        out[str(dev)] = [x.cpu() for x in (v, clip, p, sent)]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g.dtype == BF16
        torch.testing.assert_close(g.float(), w.float(), atol=BF16_ATOL,
                                   rtol=0)


def test_bf16_train_step_on_card_matches_cpu(cuda):
    """One bf16 step's loss within rtol 1e-2 and its gradients, all
    together, within relative L2 2e-2 of the CPU's plain path; every
    gradient is f32. The bf16 kernels run on the card and the f32 ones do
    not."""
    batch = _bf16_batch()
    exp = ExperimentConfig(model=BF16_CFG)
    res = {}
    for dev in ("cpu", cuda):
        model = CMHSE(BF16_CFG, 64, device=dev,
                      generator=torch.Generator().manual_seed(3))
        b = batch.to(dev)
        cuda_lib.reset_launches()
        loss, _ = total_loss(model(b), b, exp.loss)
        loss.backward()
        assert cuda_lib.launches == ({} if dev == "cpu" else {
            ("gru_fwd", "bfloat16", "save_gates"): 4,
            ("gru_fwd", "bfloat16", "save_gates+with_h0"): 2,
            ("gru_bwd", "bfloat16", "zero_h0"): 4,
            ("gru_bwd", "bfloat16", "with_h0"): 2,
            ("simhinge", "float32", "pair"): 2})
        grads = [p.grad for _, p in sorted(model.named_parameters())]
        assert all(g.dtype == torch.float32 for g in grads)
        res[str(dev)] = (loss.item(), torch.cat([g.cpu().ravel()
                                                 for g in grads]))
    card, cpu = res["cuda"], res["cpu"]
    assert abs(card[0] - cpu[0]) <= 1e-2 * abs(cpu[0])
    assert _rel_l2(card[1], cpu[1]) <= BF16_GRAD_RL2


# ---- the training loop on the card: prefetch, graphs, checkpoints ----------

def _loop_cfg(tmp_path=None, **train):
    from cmhse_tpu_torch.config import DataConfig, TrainConfig

    return ExperimentConfig(
        data=DataConfig(batch_size=8, feat_dim=20, vocab_size=64,
                        max_clips=3, max_frames=7, max_sentences=3,
                        max_words=5),
        model=ModelConfig(embed_size=32, word_dim=16, feat_dim=20,
                          rnn_hidden=32, hierarchical=True,
                          attention_pool=True, reconstruction=True),
        train=TrainConfig(lr=1e-3, checkpoint_dir=str(tmp_path or "unused"),
                          **train))


def _loop_batches(cfg, n=24, seed=0, **kw):
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)

    ds = SyntheticHierarchicalDataset(num_videos=n, feat_dim=20,
                                      vocab_size=64, max_clips=3,
                                      max_frames=7, max_words=5, seed=seed)
    return list(batches_from_dataset(ds, cfg.data, shuffle=False, **kw))


def test_prefetch_matches_batch_to_and_keeps_buffers_pinned(cuda):
    """Bucketed batches of several shapes: each prefetched batch equals
    ``Batch.to``'s, the ring holds LOOKAHEAD + 1 slots of pinned buffers,
    and the copies ran on the prefetcher's own stream."""
    from cmhse_tpu_torch.data import Prefetcher

    cfg = _loop_cfg()
    short = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, max_clips=2, max_frames=4, max_sentences=2, max_words=3))
    host = (_loop_batches(cfg, n=20) + _loop_batches(short, n=12)
            + _loop_batches(cfg, n=8, seed=1))
    assert len({b.frames.shape for b in host}) > 1
    pre = Prefetcher(cuda)
    got = [(h, b) for h, b in pre(host)]
    assert [h for h, _ in got] == host and len(pre.slots) == 3
    for h, b in got:
        want = h.to(cuda)
        for f in dataclasses.fields(Batch):
            assert torch.equal(getattr(b, f.name), getattr(want, f.name))
            assert getattr(b, f.name).device.type == "cuda"
    bufs = [t for s in pre.slots for t in s.buffers.values()]
    assert bufs and all(t.is_pinned() for t in bufs)
    pinned = host[0].pin_memory()  # Batch's own pinned copy
    for f in dataclasses.fields(Batch):
        assert getattr(pinned, f.name).is_pinned()
    placed = pinned.to(cuda, non_blocking=True)
    for f in dataclasses.fields(Batch):
        assert torch.equal(getattr(placed, f.name).cpu(),
                           torch.as_tensor(getattr(host[0], f.name)))
    assert pre.stream is not None and \
        pre.stream != torch.cuda.current_stream()


def test_prefetch_refill_waits_for_the_copy_in_flight(cuda):
    """With the copy stream held up by a long kernel, each pinned slot is
    refilled while the copy out of it is still queued: the refill must
    wait for it, or a batch would arrive with a later one's values."""
    from cmhse_tpu_torch.data import Prefetcher

    cfg = _loop_cfg()
    host = _loop_batches(cfg, n=64)
    pre = Prefetcher(cuda)
    pre.stream = torch.cuda.Stream()
    with torch.cuda.stream(pre.stream):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the copy stream
    kept = [b.frames.clone() for _, b in pre(host)]
    torch.cuda.synchronize()
    for h, frames in zip(host, kept):
        assert torch.equal(frames.cpu(), torch.as_tensor(h.frames))


def test_encode_gallery_through_prefetch_matches_pageable(cuda):
    from cmhse_tpu_torch.eval.encode import encode_batch, encode_gallery_device

    cfg = _loop_cfg()
    host = _loop_batches(cfg, n=20)
    model = CMHSE(cfg.model, 64, generator=torch.Generator().manual_seed(2))
    v, p, valid, ids = encode_gallery_device(model, host, return_ids=True)
    want = [encode_batch(model, b) for b in host]
    assert torch.equal(v, torch.cat([w[0] for w in want]))
    assert torch.equal(p, torch.cat([w[1] for w in want]))
    assert valid.device.type == "cuda" and int(valid.sum()) == 20
    np.testing.assert_array_equal(ids, np.concatenate(
        [b.video_ids for b in host]))


def test_train_step_repeats_bitwise_and_graph_replay_matches(cuda):
    """The card's train step is repeatable bit for bit (the loss's
    scatter-adds included), and ``train_steps`` (a CUDA graph of K steps,
    replayed from its second dispatch) is bitwise equal to K
    ``train_step``s, the metrics too."""
    from cmhse_tpu_torch.train import train_steps
    from cmhse_tpu_torch.train.loop import _grouped_host_batches

    cfg = _loop_cfg()
    host = _loop_batches(cfg, n=32)
    (_, _, s0), (_, _, s1) = list(_grouped_host_batches(
        [tuple(host[:2]), tuple(host[2:])], 2))
    runs = []
    for mode in ("eager", "eager", "graph"):
        model = CMHSE(cfg.model, 64,
                      generator=torch.Generator().manual_seed(1))
        state = create_train_state(cfg, model)
        losses = []
        if mode == "graph":
            for stacked in (s0, s1, s0):
                state, m = train_steps(state, stacked, cfg.loss)
                losses += m["loss"].tolist()
            assert state.graph_replays == 2
        else:
            for b in host + host[:2]:
                state, m = train_step(state, b, cfg.loss)
                losses.append(float(m["loss"]))
        runs.append((state, losses))
    (a, la), (b, lb), (g, lg) = runs
    assert la == lb == lg and a.step == g.step == 6
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
        assert torch.equal(v, g.model.state_dict()[k]), k
    for pa, pg in zip(a.model.parameters(), g.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[pa][key],
                               g.optimizer.state[pg][key]), key


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A checkpoint written on the card restores on the CPU, and one
    written on the CPU restores on the card, where training goes on
    (capturable Adam, its step counts moved to the card)."""
    from cmhse_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _loop_cfg(tmp_path)
    host = _loop_batches(cfg, n=8)
    states = {}
    for dev in (cuda, "cpu"):
        model = CMHSE(cfg.model, 64, device=dev,
                      generator=torch.Generator().manual_seed(4))
        states[str(dev)] = create_train_state(cfg, model)
    card, cpu = states["cuda"], states["cpu"]
    train_step(card, host[0], cfg.loss)
    mgr = CheckpointManager(str(tmp_path / "run"), cfg)
    mgr.save(card, epoch=1, best_rsum=3.0, groups_done=2)
    cpu, epoch, best, groups = mgr.restore(cpu)
    assert (cpu.step, epoch, best, groups) == (1, 1, 3.0, 2)
    for k, v in card.model.state_dict().items():
        assert torch.equal(v.cpu(), cpu.model.state_dict()[k]), k
    assert cpu.optimizer.param_groups[0]["capturable"] is False
    train_step(cpu, host[0], cfg.loss)
    mgr.save(cpu, epoch=1, best_rsum=3.0)
    card, _, _, _ = mgr.restore(card)
    group = card.optimizer.param_groups[0]
    assert group["capturable"] is True and group["lr"].device.type == "cuda"
    for p in card.model.parameters():
        assert card.optimizer.state[p]["step"].device.type == "cuda"
    train_step(card, host[0], cfg.loss)
    assert card.step == 3


def test_full_width_step_gradients_repeat_bitwise(cuda):
    """Two identical eager forward/backward passes at full cmhse_full width
    (batch 8) give bit-equal gradients: the loss's scatter-adds of the
    hardest negatives must not add duplicate indices in whatever order
    atomics land (they did with ``index_add_``)."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)

    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8)
    ds = SyntheticHierarchicalDataset(
        num_videos=8, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=3)
    batch = next(batches_from_dataset(ds, dc, shuffle=False)).to(cuda)
    model = CMHSE(cfg.model, dc.vocab_size,
                  generator=torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = total_loss(model(batch), batch, cfg.loss)
        loss.backward()
        runs.append({k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None})
    differ = [k for k, g in runs[0].items() if not torch.equal(g, runs[1][k])]
    assert differ == []


# ---- the command-line chain on the card: packer, evaluate ------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_batch_drives_encode_as_pad_batch(cuda, dtype):
    """The native packer's batch, moved to the card, gives the same
    embeddings as pad_batch's: the two batches are bit-equal."""
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.data import (BucketSpec, SyntheticHierarchicalDataset,
                                      pad_batch)

    ds = SyntheticHierarchicalDataset(num_videos=8, feat_dim=20,
                                      vocab_size=64, max_clips=4,
                                      max_frames=9, max_words=6, seed=7)
    examples = [ds[i] for i in range(7)]
    spec = BucketSpec(8, 3, 7, 3, 5, 20, dtype)
    cfg = ModelConfig(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
                      hierarchical=True, attention_pool=True, dtype=dtype)
    model = CMHSE(cfg, 64, generator=torch.Generator().manual_seed(2))
    out = []
    for batch in (native.pack_batch_native(examples, spec),
                  pad_batch(examples, spec)):
        b = batch.to(cuda)
        with torch.inference_mode():
            v, _ = model.encode_video(b.frames, b.frame_len, b.clip_len)
            p, _ = model.encode_text(b.words, b.word_len, b.sent_len)
        out.append((v, p))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_cli_evaluate_streaming_on_card_matches_cpu(cuda, tmp_path):
    """``cli.evaluate --streaming`` at N = 1,024 on the card (K4) dumps the
    CPU's ranks, line for line; a rank may differ only where the positive
    lies within 1e-5 of another item's score (f32 sums in another order)."""
    import json

    from cmhse_tpu_torch.cli.evaluate import main as eval_main
    from cmhse_tpu_torch.config import DataConfig
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset, build_vocab)
    from cmhse_tpu_torch.data.fixtures import write_reference_dataset
    from cmhse_tpu_torch.eval.encode import encode_data
    from cmhse_tpu_torch.train.checkpoint import eval_payload, write_best_dir

    n, data = 1024, str(tmp_path / "data")
    write_reference_dataset(data, splits=[("val", n)], feat_dim=20,
                            features="npy")
    with open(f"{data}/val_captions.json") as f:
        caps = json.load(f)
    vocab = build_vocab([s for m in caps.values() for s in m["sentences"]],
                        threshold=1)
    vocab.save(f"{data}/vocab.json")
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=64, feat_dim=20, vocab_size=len(vocab),
                        max_clips=3, max_frames=4, max_sentences=3,
                        max_words=12, data_path=data),
        model=ModelConfig(embed_size=32, word_dim=16, feat_dim=20,
                          rnn_hidden=32, hierarchical=True,
                          attention_pool=True))
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(cfg.to_json())
    model = CMHSE(cfg.model, len(vocab), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    write_best_dir(str(run), eval_payload(model.state_dict()))

    cuda_lib.reset_launches()
    assert eval_main([str(run), "--streaming", "--dump_ranks",
                      str(tmp_path / "card.jsonl")]) == 0
    assert cuda_lib.launch_count("rankcount") == 2
    assert eval_main([str(run), "--platform", "cpu", "--dump_ranks",
                      str(tmp_path / "cpu.jsonl")]) == 0

    def rows(name):
        return [json.loads(ln) for ln in (tmp_path / name).read_text()
                .splitlines()]

    card, cpu = rows("card.jsonl"), rows("cpu.jsonl")
    assert len(card) == len(cpu) == n
    ds = PrecompDataset(data, "val", Vocabulary.load(f"{data}/vocab.json"),
                        feat_dim=20)
    v, p, _ = encode_data(model, batches_from_dataset(ds, cfg.data,
                                                      shuffle=False))
    sims = v @ p.T
    for a, b in zip(card, cpu):
        assert a["index"] == b["index"] and a["key"] == b["key"]
        i = a["index"]
        for d, row in (("v2p_rank", sims[i]), ("p2v_rank", sims[:, i])):
            if a[d] != b[d]:
                gap = np.abs(np.delete(row, i) - row[i]).min()
                assert gap <= 1e-5, (i, d, a[d], b[d], gap)


# ---- every H on the card: padding and the streamed variants ----------------
# H = 30 (padded to 32), 4 past each resident W_h limit of the type, and
# 2,048 / 4,096 (streamed: W_h staged slab by slab). Held to the
# bands above: f32 1e-5 abs (forward) and 1e-4 of the largest entry
# (backward), bf16 1e-2 abs and relative L2 2e-2.

def _any_h(dtype, which):
    dt = getattr(torch, dtype)
    if which == "fwd_max+4":
        return gru_kernel.fwd_max_hidden(dt) + 4
    if which == "bwd_max+4":
        return gru_kernel.bwd_max_hidden(dt) + 4
    return int(which)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["30", "fwd_max+4", "bwd_max+4", "2048",
                                   "4096"])
@pytest.mark.parametrize("variant", ["encode", "save_gates_h0"])
def test_gru_fwd_any_hidden_matches_plain(cuda, dtype, which, variant):
    dt = getattr(torch, dtype)
    h = _any_h(dtype, which)
    b, t = 9, 5
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=h, zero_rows=(0,))]
    xw, w_h = xw.to(dt), w_h.to(dt)
    save = variant != "encode"
    h0 = (torch.randn(b, h, device=cuda) * 0.5).to(dt) if save else None
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=save)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=save)
    torch.cuda.synchronize()
    streamed = h > gru_kernel.fwd_max_hidden(dt)
    name = {"save_gates_h0": "save_gates+with_h0"}.get(variant, variant)
    assert cuda_lib.launches == {
        ("gru_fwd", dtype, name + ("+streamed" if streamed else "")): 1}
    assert [g.shape[-1] for g in got] == [h, h] + ([4 * h] if save else [])
    atol = 1e-5 if dt == torch.float32 else BF16_ATOL
    torch.testing.assert_close(got[0], want[0], atol=atol, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=atol, rtol=0)
    if save:
        live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
        torch.testing.assert_close(got[2][live], want[2][live], atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["30", "fwd_max+4", "bwd_max+4", "2048",
                                   "4096"])
@pytest.mark.parametrize("seeded", [False, True])
def test_gru_bwd_any_hidden_matches_plain(cuda, dtype, which, seeded):
    dt = getattr(torch, dtype)
    h = _any_h(dtype, which)
    b, t = 9, 5
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(
        b, t, h, seed=h + 1, zero_rows=(0,))]
    xw, w_h = xw.to(dt), w_h.to(dt)
    gen = torch.Generator(device=cuda).manual_seed(h)
    h0 = ((torch.randn(b, h, device=cuda, generator=gen) * 0.5).to(dt)
          if seeded else None)
    outs, _, gates = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths,
                                                     h0, save_gates=True)
    douts = torch.randn(b, t, h, device=cuda, generator=gen).to(dt)
    dfinal = torch.randn(b, h, device=cuda, generator=gen).to(dt)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    streamed = h > gru_kernel.bwd_max_hidden(dt)
    variant = ("with_h0" if seeded else "zero_h0") + (
        "+streamed" if streamed else "")
    assert cuda_lib.launches == {("gru_bwd", dtype, variant): 1}
    assert [g.shape[-1] for g in got] == [3 * h, h, 4 * h, h]
    for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
        assert torch.isfinite(g.float()).all(), name
        err = (_rel_err(g.float(), w.float()) if dt == torch.float32
               else _rel_l2(g, w))
        assert err <= (1e-4 if dt == torch.float32 else BF16_GRAD_RL2), (
            name, err)
    assert not got[0][0].any() and not got[1][0].any()  # the length-0 row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_streamed_equals_resident_bitwise(cuda, dtype):
    """At an H both variants take, the streamed kernels run the resident
    ones' arithmetic in its order: the same bits."""
    dt = getattr(torch, dtype)
    b, t, h = 37, 6, 1100
    xw, w_h, b_h, lengths = [a.to(cuda) for a in _gru_inputs(b, t, h, 13)]
    xw, w_h = xw.to(dt), w_h.to(dt)
    resident = gru_kernel.gru_forward(xw, w_h, b_h, lengths, save_gates=True)
    douts = torch.randn(b, t, h, device=cuda).to(dt)
    r_bwd = gru_kernel.gru_backward(resident[2], resident[0], lengths, w_h,
                                    douts)
    limits = (gru_kernel.fwd_max_hidden, gru_kernel.bwd_max_hidden)
    try:  # the wrappers read the limits through the library
        lib = cuda_lib.library()
        saved = {n: getattr(lib, n) for n in ("cmhse_gru_fwd_max_hidden",
                                              "cmhse_gru_bwd_max_hidden")}
        for n in saved:
            setattr(lib, n, lambda bf16: 4)
        cuda_lib.reset_launches()
        streamed = gru_kernel.gru_forward(xw, w_h, b_h, lengths,
                                          save_gates=True)
        s_bwd = gru_kernel.gru_backward(streamed[2], streamed[0], lengths,
                                        w_h, douts)
        assert cuda_lib.launch_count("gru_fwd", dtype,
                                     "save_gates+streamed") == 1
        assert cuda_lib.launch_count("gru_bwd", dtype,
                                     "zero_h0+streamed") == 1
    finally:
        for n, fn in saved.items():
            setattr(lib, n, fn)
    assert limits[0](dt) >= h and limits[1](dt) >= h
    live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
    assert torch.equal(resident[0], streamed[0])
    assert torch.equal(resident[1], streamed[1])
    assert torch.equal(resident[2][live], streamed[2][live])
    for a, b in zip(r_bwd, s_bwd):
        assert torch.equal(a, b)


def _many_chunk_lengths(b, t, seed):
    """Lengths for more rows than one chunk of the streamed gru_fwd, in
    random order: a fifth 0, most 1 or 2 (dead after the first steps), a
    few up to and past ``t``."""
    rng = np.random.RandomState(seed)
    lengths = rng.choice([0, 1, 2], size=b, p=[0.2, 0.4, 0.4])
    long = rng.choice(b, size=b // 10, replace=False)
    lengths[long] = rng.randint(3, t + 2, size=long.size)
    return torch.from_numpy(lengths.astype(np.int32))


# B = 600: past a chunk in both types (256 rows in f32 and in bf16 at
# H = 2,048); H 4 past the resident limit (a block's last slot partly past
# its units; W_h in 4-byte pieces), 2,048 (16-byte pieces) and 2,064 (the
# last slab cut short by H)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["fwd_max+4", "2048", "2064"])
@pytest.mark.parametrize("variant", ["encode", "save_gates", "save_gates_h0"])
def test_gru_fwd_streamed_live_rows_match_plain(cuda, dtype, which,
                                                variant):
    dt = getattr(torch, dtype)
    h = _any_h(dtype, which)
    b, t = 600, 9
    xw, w_h, b_h, _ = [a.to(cuda) for a in _gru_inputs(b, t, h, seed=h + 2)]
    lengths = _many_chunk_lengths(b, t, seed=h).to(cuda)
    xw, w_h = xw.to(dt), w_h.to(dt)
    save = variant != "encode"
    h0 = ((torch.randn(b, h, device=cuda) * 0.5).to(dt)
          if variant == "save_gates_h0" else None)
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates=save)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_forward(xw, w_h, b_h, lengths, h0, save_gates=save)
    torch.cuda.synchronize()
    name = {"save_gates_h0": "save_gates+with_h0"}.get(variant, variant)
    assert cuda_lib.launches == {("gru_fwd", dtype, name + "+streamed"): 1}
    # bf16: the kernel and the plain version round the same f32 sums, taken
    # in other orders, so a value may land one bf16 ulp away; among the
    # millions of values here some pass |2|, where an ulp (2^-7 of the
    # value at most) exceeds BF16_ATOL
    band = (dict(atol=1e-5, rtol=0) if dt == torch.float32
            else dict(atol=BF16_ATOL, rtol=2.0 ** -7))
    # outs at every step: the frozen ones too
    torch.testing.assert_close(got[0], want[0], **band)
    torch.testing.assert_close(got[1], want[1], **band)
    if save:
        live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
        torch.testing.assert_close(got[2][live], want[2][live], **band)
    dead = lengths == 0  # a length-0 row keeps its start at every step
    start = h0[dead] if h0 is not None else torch.zeros_like(got[1][dead])
    assert torch.equal(got[1][dead], start)
    assert torch.equal(got[0][dead], start[:, None].expand(-1, t, -1))


# B = 600: past a chunk of the streamed gru_bwd in both types (256 rows at
# H <= 2,112 on 132 SMs, 128 at 4,096); H 4 past the resident limit (bf16:
# H % 8 == 4, the operand through registers, W_h in 8-byte pieces), 2,048
# (16 units a block), 2,064 (the last slab cut short by 3H) and 4,096 (32
# units a block: more than one slot of 16)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["bwd_max+4", "2048", "2064", "4096"])
@pytest.mark.parametrize("seeded", [False, True])
def test_gru_bwd_streamed_live_rows_match_plain(cuda, dtype, which, seeded):
    dt = getattr(torch, dtype)
    h = _any_h(dtype, which)
    b, t = 600, 9
    xw, w_h, b_h, _ = [a.to(cuda) for a in _gru_inputs(b, t, h, seed=h + 3)]
    lengths = _many_chunk_lengths(b, t, seed=h + 4).to(cuda)
    xw, w_h = xw.to(dt), w_h.to(dt)
    gen = torch.Generator(device=cuda).manual_seed(h)
    h0 = ((torch.randn(b, h, device=cuda, generator=gen) * 0.5).to(dt)
          if seeded else None)
    outs, _, gates = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths,
                                                     h0, save_gates=True)
    douts = torch.randn(b, t, h, device=cuda, generator=gen).to(dt)
    dfinal = torch.randn(b, h, device=cuda, generator=gen).to(dt)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
    cuda_lib.reset_launches()
    got = gru_kernel.gru_backward(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    torch.cuda.synchronize()
    variant = ("with_h0" if seeded else "zero_h0") + "+streamed"
    assert cuda_lib.launches == {("gru_bwd", dtype, variant): 1}
    for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
        assert torch.isfinite(g.float()).all(), name
        err = (_rel_err(g.float(), w.float()) if dt == torch.float32
               else _rel_l2(g, w))
        assert err <= (1e-4 if dt == torch.float32 else BF16_GRAD_RL2), (
            name, err)
    dead = lengths == 0  # a length-0 row has no live step
    assert dead.any()
    assert not got[0][dead].any() and not got[1][dead].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [1024, 1100])
def test_gru_streamed_equals_resident_bitwise_many_chunks(cuda, dtype, h):
    """test_gru_streamed_equals_resident_bitwise at B = 600, past a chunk,
    with the lengths in random order (the streamed kernels multiply their
    rows in length order, the resident K1 in row order): the same bits, in
    K1's three variants and K2 with and without h0. H = 1,024 stages the
    bf16 operands by cp.async, 1,100 through registers (and K2's W_h in
    8-byte pieces)."""
    dt = getattr(torch, dtype)
    b, t = 600, 7
    xw, w_h, b_h, _ = [a.to(cuda) for a in _gru_inputs(b, t, h, 17)]
    lengths = _many_chunk_lengths(b, t, seed=h + 1).to(cuda)
    xw, w_h = xw.to(dt), w_h.to(dt)
    h0 = (torch.randn(b, h, device=cuda) * 0.5).to(dt)
    variants = [(None, False), (None, True), (h0, True)]
    resident = [gru_kernel.gru_forward(xw, w_h, b_h, lengths, s0, save)
                for s0, save in variants]
    lib = cuda_lib.library()
    saved = lib.cmhse_gru_fwd_max_hidden
    try:  # the wrapper reads the limit through the library
        lib.cmhse_gru_fwd_max_hidden = lambda bf16: 4
        cuda_lib.reset_launches()
        streamed = [gru_kernel.gru_forward(xw, w_h, b_h, lengths, s0, save)
                    for s0, save in variants]
        assert cuda_lib.launches == {
            ("gru_fwd", dtype, v + "+streamed"): 1
            for v in ("encode", "save_gates", "save_gates+with_h0")}
    finally:
        lib.cmhse_gru_fwd_max_hidden = saved
    assert gru_kernel.fwd_max_hidden(dt) >= h
    live = (torch.arange(t, device=cuda)[None, :] < lengths[:, None])
    for r, s in zip(resident, streamed):
        assert torch.equal(r[0], s[0])
        assert torch.equal(r[1], s[1])
        if len(r) == 3:
            assert torch.equal(r[2][live], s[2][live])
    # K2 on the resident forward's gates (save_gates, save_gates + h0)
    gen = torch.Generator(device=cuda).manual_seed(h)
    douts = torch.randn(b, t, h, device=cuda, generator=gen).to(dt)
    dfinal = torch.randn(b, h, device=cuda, generator=gen).to(dt)
    cases = [(resident[1], None), (resident[2], h0)]

    def backward():
        return [gru_kernel.gru_backward(f[2], f[0], lengths, w_h, douts,
                                        dfinal, s0) for f, s0 in cases]

    r_bwd = backward()
    saved = lib.cmhse_gru_bwd_max_hidden
    try:
        lib.cmhse_gru_bwd_max_hidden = lambda bf16: 4
        cuda_lib.reset_launches()
        s_bwd = backward()
        assert cuda_lib.launches == {
            ("gru_bwd", dtype, v + "+streamed"): 1
            for v in ("zero_h0", "with_h0")}
    finally:
        lib.cmhse_gru_bwd_max_hidden = saved
    assert gru_kernel.bwd_max_hidden(dt) >= h
    for r, s in zip(r_bwd, s_bwd):
        for a, c in zip(r, s):
            assert torch.equal(a, c)


def test_trainable_gru_at_h30_on_card_matches_cpu(cuda):
    """TrainableGRU forward and backward at H = 30 (padded to 32 on the
    card) against the CPU's plain path, seeded and not."""
    rng = np.random.RandomState(30)
    b, t, d, h = 11, 6, 9, 30
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[2] = 0
    params = [(rng.randn(*s) * 0.2).astype(np.float32)
              for s in ((d, 3 * h), (h, 3 * h), (3 * h,), (3 * h,), (b, h))]
    co = rng.randn(b, t, h).astype(np.float32)
    for seeded in (False, True):
        grads, outs_by = {}, {}
        for dev in ("cpu", cuda):
            w_i, w_h, b_i, b_h, h0 = [torch.from_numpy(p).to(dev)
                                      .requires_grad_() for p in params]
            xw = torch.from_numpy(x).to(dev) @ w_i + b_i
            outs, final = gru_kernel.gru_recurrence(
                xw, w_h, b_h, torch.from_numpy(lengths).to(dev),
                h0 if seeded else None)
            ((outs * torch.from_numpy(co).to(dev)).sum()
             + (final ** 2).sum()).backward()
            outs_by[str(dev)] = outs.detach().cpu()
            grads[str(dev)] = [p.grad.cpu() for p in (w_i, w_h, b_i, b_h)]
            if seeded:
                grads[str(dev)].append(h0.grad.cpu())
        torch.testing.assert_close(outs_by["cuda"], outs_by["cpu"],
                                   atol=1e-5, rtol=0)
        for g, w in zip(grads["cuda"], grads["cpu"]):
            assert _rel_err(g, w) <= 1e-4


def test_full_config_step_at_rnn_hidden_30_on_card(cuda):
    """One cmhse_full train step with rnn_hidden = 30 (the JAX CLI trains
    any H) on the card against the CPU: loss, grad_norm and every
    gradient, in the bands of test_train_step_on_card_matches_cpu."""
    from cmhse_tpu_torch.config import get_preset

    exp = get_preset("cmhse_full")
    mc = dataclasses.replace(exp.model, rnn_hidden=30, embed_size=32,
                             word_dim=16, feat_dim=20)
    exp = dataclasses.replace(exp, model=mc)
    rng = np.random.RandomState(2)
    batch = Batch(frames=rng.randn(6, 3, 7, 20).astype(np.float32),
                  frame_len=rng.randint(0, 8, (6, 3)).astype(np.int32),
                  clip_len=rng.randint(1, 4, 6).astype(np.int32),
                  words=rng.randint(0, 64, (6, 3, 5)).astype(np.int32),
                  word_len=rng.randint(0, 6, (6, 3)).astype(np.int32),
                  sent_len=rng.randint(1, 4, 6).astype(np.int32),
                  video_ids=np.arange(6, dtype=np.int32),
                  valid=np.array([1, 1, 1, 1, 1, 0], bool))
    grads, metrics = {}, {}
    for dev in ("cpu", cuda):
        model = CMHSE(mc, 64, device=dev,
                      generator=torch.Generator().manual_seed(3))
        cuda_lib.reset_launches()
        state, m = train_step(create_train_state(exp, model), batch,
                              exp.loss)
        if dev != "cpu":
            assert cuda_lib.launch_count("gru_fwd") == 6
            assert cuda_lib.launch_count("gru_bwd") == 6
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        grads[str(dev)] = {k: p.grad.cpu()
                           for k, p in model.named_parameters()}
    for k, g in grads["cuda"].items():
        assert _rel_err(g, grads["cpu"][k]) <= 1e-4, k
    for k, v in metrics["cuda"].items():
        assert abs(v - metrics["cpu"][k]) <= 1e-4 * abs(metrics["cpu"][k]), k


def test_nccl_world_1_dp_step_equals_train_step_bitwise(cuda, tmp_path):
    """The data-parallel step on one NCCL rank (its gather, the global
    loss, the flat all-reduce and the division by one) against the plain
    step from the same weights on the same batches: every parameter, Adam
    moment and metric equal bit for bit; and K = 2 steps a dispatch
    captured with their collectives replay the eager steps' bits."""
    import torch.distributed as dist

    from cmhse_tpu_torch.parallel import make_mesh, place_state
    from cmhse_tpu_torch.train import train_steps

    cfg = ModelConfig(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
                      hierarchical=True, attention_pool=True,
                      reconstruction=True)
    exp = ExperimentConfig(model=cfg)
    rng = np.random.RandomState(9)
    batches = [Batch(frames=rng.randn(6, 3, 7, 20).astype(np.float32),
                     frame_len=rng.randint(0, 8, (6, 3)).astype(np.int32),
                     clip_len=rng.randint(1, 4, 6).astype(np.int32),
                     words=rng.randint(0, 64, (6, 3, 5)).astype(np.int32),
                     word_len=rng.randint(0, 6, (6, 3)).astype(np.int32),
                     sent_len=rng.randint(1, 4, 6).astype(np.int32),
                     video_ids=np.arange(6, dtype=np.int32),
                     valid=np.ones(6, bool)) for _ in range(2)]

    def state():
        return create_train_state(exp, CMHSE(
            cfg, 64, device=cuda, generator=torch.Generator().manual_seed(4)))

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(device=cuda)
        plain, dp = state(), place_state(state(), mesh)
        for b in batches:
            plain, m1 = train_step(plain, b, exp.loss)
            dp, m2 = train_step(dp, b, exp.loss, mesh=mesh)
            for k in m1:
                assert torch.equal(m1[k], m2[k]), k
        for (name, a), b in zip(plain.model.state_dict().items(),
                                dp.model.state_dict().values()):
            assert torch.equal(a, b), name
        for p, q in zip(plain.model.parameters(), dp.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(plain.optimizer.state[p][key],
                                   dp.optimizer.state[q][key])
        stacked = Batch(**{f.name: np.stack([getattr(b, f.name)
                                             for b in batches])
                           for f in dataclasses.fields(Batch)})
        graph, eager = place_state(state(), mesh), place_state(state(), mesh)
        for _ in range(2):
            graph, _ = train_steps(graph, stacked, exp.loss, mesh=mesh)
            for b in batches:
                eager, _ = train_step(eager, b, exp.loss, mesh=mesh)
        assert graph.graph_refused is None and graph.graph_replays == 1
        for (name, a), b in zip(graph.model.state_dict().items(),
                                eager.model.state_dict().values()):
            assert torch.equal(a, b), name
    finally:
        dist.destroy_process_group()
