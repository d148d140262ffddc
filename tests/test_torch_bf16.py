"""The port's bf16 mixed-precision configuration against the JAX package's,
on the CPU: bf16 ``frames`` bit-equal to JAX's ``pad_batch``; the plain
versions of the bf16 ``gru_fwd`` (three variants) and ``gru_bwd`` (with and
without h0) against ``pallas_gru_sequence`` / ``_gru_bwd_pallas`` in bf16
(Pallas, interpret mode); ``TrainableGRU`` against ``jax.grad`` of
``pallas_gru_trainable``; the whole bf16 model (``dtype="bfloat16"``,
``pallas_gru=True`` on the JAX side, f32 params carried by
``params_from_jax``): encode, forward with decoders, one step's loss and
gradients; the attention pool's gradients; the ``lowp`` rank count against
``pallas_rank_counts``; and the bf16 serving path.

Tolerances are the JAX package's own bf16 bands: forward values within
``atol 1e-2`` (tests/test_pallas_gru.py), gradients within a relative L2
error of ``2e-2`` (tests/test_pallas_gru_grad.py). Each test asserts the
band and reports the worst value it saw in its failure message; the worst
values seen here are noted beside each band.

At random init the in-batch similarities lie within ~1e-3 of each other,
so one bf16 ulp can change which negative is hardest, in the JAX package
too (between its bf16 and f32 runs); a changed pick sends that row's
gradient to another pair. So the whole-model gradients are compared with
the negatives pinned: ``pinned_total_loss_jax`` here and the port's
``total_loss_at`` take the picks (for each valid query, the pair the
max-of-hinges loss picks, both directions, both levels), and each
parameter gets its own band (``_leaf_bands``).

Run as a script, this module counts over N init seeds how often the port's
bf16 picks differ from JAX's bf16 picks, and how often JAX's bf16 picks
differ from its f32 ones (the same weights and batch)::

    python -m tests.test_torch_bf16 --seeds 20
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # also when run as a script

import argparse  # noqa: E402
import dataclasses  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cmhse_tpu.config import DataConfig as JaxDataConfig  # noqa: E402
from cmhse_tpu.config import LossConfig as JaxLossConfig  # noqa: E402
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset  # noqa: E402
from cmhse_tpu.data import batches_from_dataset as jax_batches  # noqa: E402
from cmhse_tpu.models import CMHSE as JaxCMHSE  # noqa: E402
from cmhse_tpu.ops.loss import reconstruction_loss as jax_recon  # noqa: E402
from cmhse_tpu.ops.pallas_gru import pallas_gru_sequence  # noqa: E402
from cmhse_tpu.ops.pallas_gru_grad import (_gru_bwd_pallas,  # noqa: E402
                                           pallas_gru_trainable)
from cmhse_tpu.ops.pallas_sim import (pallas_rank_counts,  # noqa: E402
                                     pallas_violation_counts)
from cmhse_tpu.train.objective import total_loss as jax_total_loss  # noqa: E402
from cmhse_tpu_torch.config import (DataConfig, LossConfig,  # noqa: E402
                                    ModelConfig)
from cmhse_tpu_torch.data import (Batch,  # noqa: E402
                                  SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.eval import (Retriever, encode_data,  # noqa: E402
                                  encode_gallery_device, validate_metrics)
from cmhse_tpu_torch.eval.retrieval import \
    streaming_bidirectional_metrics  # noqa: E402
from cmhse_tpu_torch.interop import params_from_jax  # noqa: E402
from cmhse_tpu_torch.models import CMHSE  # noqa: E402
from cmhse_tpu_torch.models.gru import gru_input_projection  # noqa: E402
from cmhse_tpu_torch.ops import gru_kernel, rankcount_kernel  # noqa: E402
from cmhse_tpu_torch.ops.topk import topk_lowest_index  # noqa: E402
from cmhse_tpu_torch.train import (hardest_negatives, total_loss,  # noqa: E402
                                   total_loss_at)
from tests.make_goldens import CONFIGS  # noqa: E402

torch.set_num_threads(2)
BF16 = torch.bfloat16
FWD_ATOL = 1e-2   # tests/test_pallas_gru.py's bf16 band
GRAD_RL2 = 2e-2   # tests/test_pallas_gru_grad.py's bf16 band


def _torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor of the same dtype (bf16 by
    its bits)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _max_err(got, want) -> float:
    return float(np.abs(_f32(got) - _f32(want)).max()) if np.size(
        _f32(want)) else 0.0


def _rel_l2(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


DS = dict(num_videos=12, feat_dim=20, vocab_size=64, max_clips=3,
          max_frames=6, max_words=5, seed=7)
DATA = dict(batch_size=8, feat_dim=20, vocab_size=64, max_clips=3,
            max_frames=6, max_sentences=3, max_words=5,
            feature_dtype="bfloat16")


def _bf16_models(name: str, seed: int = 123):
    """The JAX model in bf16 with the Pallas GRUs (interpret mode on the
    CPU), its f32 params carried into the port's bf16 model, and one bf16
    batch of each."""
    mcfg = dataclasses.replace(CONFIGS[name], dtype="bfloat16",
                               pallas_gru=True)
    jb = next(iter(jax_batches(JaxDataset(**DS), JaxDataConfig(**DATA),
                               shuffle=False)))
    jm = JaxCMHSE(cfg=mcfg, vocab_size=DS["vocab_size"])
    params = jm.init(jax.random.PRNGKey(seed), jb)["params"]
    pm = CMHSE(ModelConfig(**dataclasses.asdict(mcfg)), DS["vocab_size"],
               device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    pb = next(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                   DataConfig(**DATA), shuffle=False))
    return jm, params, pm, jb, pb.to("cpu")


def jax_hardest_negatives(out, batch_valid) -> list[np.ndarray]:
    """The picks of the JAX model's outputs, laid out as the port's
    ``hardest_negatives`` lays them out: per level (high, then low), row
    i's hardest negative column, then column j's hardest negative row, -1
    where the query is invalid or has no negative. The batch's video ids
    are distinct, so each level's positives are its diagonal."""
    low_valid = np.asarray(out.clip_valid & out.sent_valid).ravel()
    picks = []
    for ka, kb, valid in (("video_emb", "para_emb", np.asarray(batch_valid)),
                          ("clip_emb", "sent_emb", low_valid)):
        a, b = _f32(getattr(out, ka)), _f32(getattr(out, kb))
        sims = a.reshape(-1, a.shape[-1]) @ b.reshape(-1, b.shape[-1]).T
        valid = valid.astype(bool)
        neg = ~np.eye(len(sims), dtype=bool) & valid[None, :] & valid[:, None]
        sims[~neg] = -np.inf
        for axis in (1, 0):
            pick = sims.argmax(axis)
            pick[~(neg.any(axis) & valid)] = -1
            picks.append(pick.astype(np.int64))
    return picks


def port_hardest_negatives(out, batch, cfg) -> list[np.ndarray]:
    return [p.cpu().numpy() for p in hardest_negatives(out, batch, cfg)]


def pinned_total_loss_jax(out, batch, cfg, picks):
    """JAX's ``total_loss`` with the hardest negatives ``picks`` given
    instead of searched: the JAX side of the port's ``total_loss_at``."""
    loss = jnp.float32(0.0)
    low_valid = (out.clip_valid & out.sent_valid).reshape(-1)
    levels = ((out.video_emb, out.para_emb, batch.valid, cfg.high_weight),
              (out.clip_emb, out.sent_emb, low_valid, cfg.low_weight))
    for lvl, (a, b, valid, weight) in enumerate(levels):
        a = a.reshape(-1, a.shape[-1]).astype(jnp.float32)
        b = b.reshape(-1, b.shape[-1]).astype(jnp.float32)
        diag = jnp.sum(a * b, axis=-1)
        cost = jnp.zeros_like(diag)
        for pick, other in ((picks[2 * lvl], lambda i: b[i] * a),
                            (picks[2 * lvl + 1], lambda i: a[i] * b)):
            pick = jnp.asarray(pick)
            sims = jnp.sum(other(jnp.maximum(pick, 0)), axis=-1)
            hinge = jnp.maximum(cfg.margin + sims - diag, 0.0)
            cost = cost + jnp.where(pick >= 0, hinge, 0.0)
        n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
        loss = loss + weight * jnp.sum(jnp.where(valid, cost, 0.0)) / n_valid
    if cfg.recon_weight and out.video_recon is not None:
        loss = loss + cfg.recon_weight * (
            jax_recon(out.video_recon, out.clip_emb, out.clip_valid)
            + jax_recon(out.text_recon, out.sent_emb, out.sent_valid))
    return loss


# ---- data ------------------------------------------------------------------


@pytest.mark.parametrize("opts", [dict(shuffle=False),
                                  dict(shuffle=True, seed=2,
                                       fixed_shape=False)])
def test_bf16_frames_bit_equal_to_jax(opts):
    """frames rounded to nearest even, as ml_dtypes' astype in JAX's
    pad_batch; every other field equal; Batch.to keeps bf16."""
    got = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                    DataConfig(**DATA), **opts))
    want = list(jax_batches(JaxDataset(**DS), JaxDataConfig(**DATA), **opts))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.frames.dtype == BF16
        wf = np.asarray(w.frames)
        assert wf.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            g.frames.view(torch.int16).numpy(), wf.view(np.int16))
        for f in dataclasses.fields(Batch):
            if f.name != "frames":
                np.testing.assert_array_equal(getattr(g, f.name),
                                              np.asarray(getattr(w, f.name)))
        t = g.to("cpu")
        assert t.frames.dtype == BF16 and torch.equal(t.frames, g.frames)


def test_bf16_frames_round_to_nearest_even():
    from cmhse_tpu_torch.data import RaggedExample, pad_batch
    from cmhse_tpu_torch.data.bucketing import BucketSpec

    # 1 + 2**-8 is halfway between two bf16 values: ties go to the even one
    vals = np.array([[1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.0]],
                    np.float32)
    ex = RaggedExample(video_id=0, key="v", clips=[vals], sentences=[[1]])
    b = pad_batch([ex], BucketSpec(1, 1, 1, 1, 1, 4, "bfloat16"))
    assert b.frames[0, 0, 0].tolist() == [1.0, 1 + 2**-6, -1.0, 3.0]
    with pytest.raises(ValueError):
        BucketSpec(1, 1, 1, 1, 1, 4, "float16")


# ---- the GRU kernels' plain versions ----------------------------------------

# (B, T, D, H, zero-length rows): tiny; batch not a multiple of 8; T = 1
SHAPES = [(6, 5, 8, 16, (0,)), (19, 7, 12, 8, (3, 18)), (10, 1, 8, 16, (2,))]


def _gru_setup(b, t, d, h, zero_rows, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[list(zero_rows)] = 0
    w_i = (rng.randn(d, 3 * h) * 0.3).astype(np.float32)
    w_h = (rng.randn(h, 3 * h) * 0.3).astype(np.float32)
    b_i = (rng.randn(3 * h) * 0.1).astype(np.float32)
    b_h = (rng.randn(3 * h) * 0.1).astype(np.float32)
    h0 = (rng.randn(b, h) * 0.5).astype(np.float32)
    co = rng.randn(b, t, h).astype(np.float32)
    cf = rng.randn(b, h).astype(np.float32)
    return x, lengths, w_i, w_h, b_i, b_h, h0, co, cf


@pytest.mark.parametrize("variant", ["encode", "save_gates", "save_gates_h0"])
@pytest.mark.parametrize("b,t,d,h,zero_rows", SHAPES)
def test_gru_forward_bf16_matches_pallas(variant, b, t, d, h, zero_rows):
    """Worst seen ~4e-3 (one bf16 ulp at |h| ~ 1) against atol 1e-2."""
    x, lengths, w_i, w_h, b_i, b_h, h0, _, _ = _gru_setup(
        b, t, d, h, zero_rows, seed=b + t)
    save = variant != "encode"
    jh0 = jnp.asarray(h0) if variant == "save_gates_h0" else None
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jres = pallas_gru_sequence(jx, jnp.asarray(lengths), jnp.asarray(w_i),
                               jnp.asarray(w_h), jnp.asarray(b_i),
                               jnp.asarray(b_h), save_gates=save, h0=jh0)
    th0 = _torch(h0) if jh0 is not None else None
    xw = gru_input_projection(_torch(jx), _torch(w_i), _torch(b_i))
    assert xw.dtype == BF16
    res = gru_kernel.gru_recurrence_plain(xw, _torch(w_h), _torch(b_h),
                                          _torch(lengths), th0,
                                          save_gates=save)
    assert all(r.dtype == BF16 for r in res)
    errs = {"outs": _max_err(res[0], jres[0]),
            "final": _max_err(res[1], jres[1])}
    if save:
        live = np.arange(t)[None, :] < lengths[:, None]
        jgates = np.swapaxes(_f32(jres[2]), 0, 1)[:b]
        errs["gates"] = _max_err(_f32(res[2])[live], jgates[live])
    assert max(errs.values()) <= FWD_ATOL, errs
    for r in zero_rows:  # a length-0 row keeps its initial state
        want = h0[r].astype(jnp.bfloat16) if th0 is not None else 0.0
        np.testing.assert_array_equal(_f32(res[1][r]), _f32(want) * np.ones(h))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,d,h,zero_rows", SHAPES)
def test_gru_backward_bf16_matches_pallas(seeded, b, t, d, h, zero_rows):
    """The plain bf16 BPTT fed JAX's own bf16 gates and outputs. Worst
    relative L2 seen ~4e-3 against 2e-2."""
    x, lengths, w_i, w_h, b_i, b_h, h0, co, cf = _gru_setup(
        b, t, d, h, zero_rows, seed=2 * b + t)
    jh0 = jnp.asarray(h0).astype(jnp.bfloat16) if seeded else None
    _, _, jgates, jraw = pallas_gru_sequence(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(lengths),
        jnp.asarray(w_i), jnp.asarray(w_h), jnp.asarray(b_i),
        jnp.asarray(b_h), save_gates=True, h0=jh0)
    jco = jnp.asarray(co).astype(jnp.bfloat16)
    jcf = jnp.asarray(cf).astype(jnp.bfloat16)
    j_dxw, j_dhn, j_db, _, j_dh0 = _gru_bwd_pallas(
        jgates, jraw, jco, jcf, jnp.asarray(lengths), jnp.asarray(w_h),
        h0=jh0)
    gates = _torch(np.swapaxes(np.asarray(jgates), 0, 1)[:b])
    outs = _torch(np.swapaxes(np.asarray(jraw), 0, 1)[:b])
    th0 = _torch(jh0) if seeded else None
    dxw, dhn, db, dh0 = gru_kernel.gru_backward_plain(
        gates, outs, _torch(lengths), _torch(w_h).to(BF16), _torch(jco),
        _torch(jcf), th0)
    assert (dxw.dtype, dhn.dtype, db.dtype, dh0.dtype) == (BF16, BF16,
                                                           torch.float32,
                                                           BF16)
    errs = {"dxw": _rel_l2(dxw, np.swapaxes(_f32(j_dxw), 0, 1)[:b]),
            "dhn": _rel_l2(dhn, np.swapaxes(_f32(j_dhn), 0, 1)[:b]),
            "db": _rel_l2(db, j_db)}
    if seeded:
        errs["dh0"] = _rel_l2(dh0, _f32(j_dh0)[:b])
    assert max(errs.values()) <= GRAD_RL2, errs
    for r in zero_rows:  # no gate gradient on a length-0 row
        assert not dxw[r].any() and not dhn[r].any()


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,d,h,zero_rows", SHAPES)
def test_trainable_gru_bf16_grads_match_jax(seeded, b, t, d, h, zero_rows):
    """TrainableGRU and the projection's backward through autograd against
    jax.grad of pallas_gru_trainable, x in bf16, f32 parameters: every
    parameter gradient comes back f32. Worst relative L2 seen ~6e-3
    against 2e-2."""
    x, lengths, w_i, w_h, b_i, b_h, h0, co, cf = _gru_setup(
        b, t, d, h, zero_rows, seed=3 * b + t)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jh0 = jnp.asarray(h0).astype(jnp.bfloat16) if seeded else None
    names = ["dx", "dW_i", "dW_h", "db_i", "db_h"] + (["dh0"] if seeded
                                                      else [])

    def jloss(x_, w_i_, w_h_, b_i_, b_h_, h0_):
        outs, final = pallas_gru_trainable(x_, jnp.asarray(lengths), w_i_,
                                           w_h_, b_i_, b_h_, h0=h0_)
        return (jnp.sum(outs.astype(jnp.float32) * co)
                + jnp.sum(final.astype(jnp.float32) * cf))

    argnums = tuple(range(6 if seeded else 5))
    want = jax.grad(jloss, argnums=argnums)(
        jx, *[jnp.asarray(a) for a in (w_i, w_h, b_i, b_h)], jh0)

    tx = _torch(jx).requires_grad_()
    params = [_torch(a).requires_grad_() for a in (w_i, w_h, b_i, b_h)]
    th0 = _torch(jh0).requires_grad_() if seeded else None
    xw = gru_input_projection(tx, params[0], params[2])
    outs, final = gru_kernel.gru_recurrence(xw, params[1], params[3],
                                            _torch(lengths), th0)
    assert type(outs.grad_fn).__name__ == "TrainableGRUBackward"
    ((outs.float() * _torch(co)).sum()
     + (final.float() * _torch(cf)).sum()).backward()
    got = [tx.grad, params[0].grad, params[1].grad, params[2].grad,
           params[3].grad] + ([th0.grad] if seeded else [])
    assert [g.dtype for g in got] == [BF16] + [torch.float32] * 4 + (
        [BF16] if seeded else [])
    errs = {n: _rel_l2(g, w) for n, g, w in zip(names, got, want)}
    assert max(errs.values()) <= GRAD_RL2, errs


def test_gru_recurrence_bf16_no_grad_rounds_the_parameters():
    """The encode path: f32 W_h and h0 with a bf16 xw go through the bf16
    recurrence (rounded, as pallas_gru_sequence rounds them), equal to the
    plain version given the rounded tensors."""
    x, lengths, w_i, w_h, b_i, b_h, h0, _, _ = _gru_setup(7, 4, 6, 8, (1,), 9)
    xw = gru_input_projection(_torch(x).to(BF16), _torch(w_i), _torch(b_i))
    with torch.no_grad():
        got = gru_kernel.gru_recurrence(xw, _torch(w_h), _torch(b_h),
                                        _torch(lengths), _torch(h0))
    want = gru_kernel.gru_recurrence_plain(
        xw, _torch(w_h).to(BF16), _torch(b_h), _torch(lengths),
        _torch(h0).to(BF16))
    for a, w in zip(got, want):
        assert a.dtype == BF16 and torch.equal(a, w)


# ---- the whole bf16 model -------------------------------------------------


@pytest.mark.parametrize("name", ["hier", "full"])
def test_bf16_encode_matches_jax(name):
    """encode_video / encode_text: bf16 embeddings within atol 1e-2 of the
    JAX bf16 model's (worst seen ~8e-3, one bf16 ulp of the 0.2-0.5
    entries)."""
    jm, params, pm, jb, pb = _bf16_models(name)
    jv, jclip = jm.apply({"params": params}, jb.frames, jb.frame_len,
                         jb.clip_len, method=JaxCMHSE.encode_video)
    jp, jsent = jm.apply({"params": params}, jb.words, jb.word_len,
                         jb.sent_len, method=JaxCMHSE.encode_text)
    with torch.no_grad():
        v, clip = pm.encode_video(pb.frames, pb.frame_len, pb.clip_len)
        p, sent = pm.encode_text(pb.words, pb.word_len, pb.sent_len)
    assert {x.dtype for x in (v, clip, p, sent)} == {BF16}
    errs = {k: _max_err(g, w) for k, g, w in (
        ("video", v, jv), ("clip", clip, jclip), ("para", p, jp),
        ("sent", sent, jsent))}
    assert max(errs.values()) <= FWD_ATOL, errs


def test_bf16_forward_with_decoders_matches_jax():
    """The training forward of ``full``. The decoders (T = 3 < 16) take
    JAX's bf16-carry scan there and the port's seeded kernels with an f32
    carry, so they agree within the band, not to f32 accuracy (worst seen
    ~1e-2 on entries up to ~1.5; band 2 bf16 ulps there, 3e-2)."""
    jm, params, pm, jb, pb = _bf16_models("full")
    jo = jm.apply({"params": params}, jb)
    with torch.no_grad():
        o = pm(pb)
    errs = {k: _max_err(getattr(o, k), getattr(jo, k))
            for k in ("video_emb", "para_emb", "clip_emb", "sent_emb")}
    assert max(errs.values()) <= FWD_ATOL, errs
    recon = {k: _max_err(getattr(o, k), getattr(jo, k))
             for k in ("video_recon", "text_recon")}
    assert o.video_recon.dtype == BF16
    assert max(recon.values()) <= 3 * FWD_ATOL, recon


SEEDS = (0, 1, 2)  # init seeds of the whole-model gradient checks
# A parameter whose JAX bf16 gradient lies within this relative L2
# distance of JAX's f32 one (the same weights and negatives) is one that
# bf16 determines; only the attention pools' may lie further off, because
# a softmax's score gradients sum to zero over the steps
DETERMINED = 0.1
CONSISTENT = 1e-3  # the pinned objective against the objective, own picks
BF16_ULP = 2.0**-8  # bf16's relative spacing at 1


def _grads_by_name(model, loss, retain: bool) -> dict[str, torch.Tensor]:
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                retain_graph=retain, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named, grads)}


def _total_rel(got: dict, want: dict) -> float:
    keys = sorted(want)
    return _rel_l2(np.concatenate([_f32(got[k]).ravel() for k in keys]),
                   np.concatenate([_f32(want[k]).ravel() for k in keys]))


def _leaf_bands(got: dict, want: dict, want32: dict) -> tuple[dict, dict]:
    """Each parameter's error against its band, as a share of it (<= 1
    passes). A parameter bf16 determines (its bf16 and f32 reference
    gradients within DETERMINED): relative L2 within GRAD_RL2 plus three
    times that spread, so at most 0.32 and a zero or sign-flipped gradient
    fails. Any other parameter (only the attention pools': their
    gradients are near-cancelling sums that bf16 rounding alone moves by
    20-340%, so a zero would pass here too; they are held apart,
    well-conditioned, by ``test_bf16_attention_pool_grads_match_flax``):
    max abs error within one bf16 ulp (BF16_ULP) of the largest gradient
    entry of its encoder stage. Returns (shares of the determined, shares
    of the others)."""
    spread = {k: _rel_l2(want[k], want32[k]) for k in want}
    loose = {k for k, s in spread.items() if s > DETERMINED}
    assert all(".attn_pool." in k for k in loose), sorted(loose)
    stage = {}
    for k, w in want.items():
        name = k.split(".")[0]
        stage[name] = max(stage.get(name, 0.0), float(np.abs(_f32(w)).max()))
    tight = {k: _rel_l2(got[k], want[k]) / (GRAD_RL2 + 3 * spread[k])
             for k in want if k not in loose}
    rest = {k: _max_err(got[k], want[k])
            / (BF16_ULP * max(stage[k.split(".")[0]], 1e-30)) for k in loose}
    return tight, rest


def _check_train_step(name: str, seed: int) -> dict:
    """One bf16 step of the port against the JAX bf16 model on the same
    weights (see test_bf16_train_step_loss_and_grads_match_jax). Returns
    the worst values seen."""
    jm, params, pm, jb, pb = _bf16_models(name, seed)
    jcfg = JaxLossConfig(recon_weight=5e-4 if name == "full" else 0.0)
    pcfg = LossConfig(**dataclasses.asdict(jcfg))
    jm32 = JaxCMHSE(cfg=dataclasses.replace(jm.cfg, dtype="float32"),
                    vocab_size=DS["vocab_size"])
    picks = jax_hardest_negatives(jm.apply({"params": params}, jb), jb.valid)

    def jgrad(model, loss_fn, **kw):
        return jax.value_and_grad(
            lambda p: loss_fn(model.apply({"params": p}, jb)), **kw)(params)

    (_, jmetrics), j_real = jgrad(
        jm, lambda o: jax_total_loss(o, jb, jcfg), has_aux=True)
    _, j16 = jgrad(jm, lambda o: pinned_total_loss_jax(o, jb, jcfg, picks))
    _, j32 = jgrad(jm32, lambda o: pinned_total_loss_jax(o, jb, jcfg, picks))
    j_real, j16, j32 = (params_from_jax(jax.tree.map(np.asarray, g))
                        for g in (j_real, j16, j32))

    out = pm(pb)
    loss, metrics = total_loss(out, pb, pcfg)
    assert loss.dtype == torch.float32
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(jmetrics[k]),
                                   rtol=1e-2, err_msg=k)
    p_real = _grads_by_name(pm, loss, retain=True)
    own = port_hardest_negatives(out, pb, pcfg)
    p_own = _grads_by_name(pm, total_loss_at(
        out, pb, pcfg, [torch.from_numpy(p) for p in own]), retain=True)
    p16 = _grads_by_name(pm, total_loss_at(
        out, pb, pcfg, [torch.from_numpy(p) for p in picks]), retain=False)
    assert set(p16) == set(j16)
    assert all(g.dtype == torch.float32 for g in p16.values())
    worst = {"jax consistency": _total_rel(j16, j_real),
             "port consistency": _total_rel(p_own, p_real)}
    assert max(worst.values()) <= CONSISTENT, worst
    worst["all"] = _total_rel(p16, j16)
    assert worst["all"] <= GRAD_RL2, worst
    tight, rest = _leaf_bands(p16, j16, j32)
    for label, shares in (("determined", tight), ("attention pools", rest)):
        if shares:
            k = max(shares, key=shares.get)
            worst[label] = (k, shares[k])
            assert shares[k] <= 1.0, worst
    return worst


@pytest.mark.parametrize("name", ["hier", "full"])
def test_bf16_train_step_loss_and_grads_match_jax(name):
    """One step of the bf16 model (hardest-negative loss, through the
    fused sim+hinge path) against jax.value_and_grad of the JAX bf16 model.

    At random init the similarities lie within ~1e-3 of each other, so a
    bf16 ulp can change which negative is hardest; a changed pick sends a
    row's gradient elsewhere. So the gradients are compared with the
    negatives pinned to JAX's picks on both sides
    (``pinned_total_loss_jax``, ``total_loss_at``), whatever the seed; on
    each side the pinned objective must give the objective's gradients at
    its own picks (relative L2 within 1e-3; seen ~1e-4).

    Bands: the f32 loss and its terms within rtol 1e-2; all gradients
    together within relative L2 2e-2 (worst seen 9.5e-3 over init seeds
    0-4); per parameter as ``_leaf_bands`` says (worst seen 0.61 of the
    band for a parameter bf16 determines, 0.07 for the attention pools')."""
    _check_train_step(name, SEEDS[0])


@pytest.mark.parametrize("seed", SEEDS[1:])
@pytest.mark.parametrize("name", ["hier", "full"])
def test_bf16_train_step_grads_match_jax_more_seeds(name, seed):
    """The same check at other init seeds."""
    _check_train_step(name, seed)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_attention_pool_grads_match_flax(seed):
    """The bf16 attention pool alone (flax's ``Dense(dtype)`` rule, tanh,
    masked softmax) against the JAX package's in bf16, on well-conditioned
    inputs: states ~ N(0, 1) that differ from step to step, a non-zero
    ``proj`` bias, a length-0 row. There every gradient (states, both
    kernels, the bias) is one bf16 determines, so each is held to the
    per-parameter band of the whole model: relative L2 within 2e-2 plus
    three times JAX's own bf16-vs-f32 spread (spread seen <= 0.03, error
    ~0.4 of its band)."""
    from cmhse_tpu.models.encoders import AttentionPool as JaxPool
    from cmhse_tpu_torch.models.encoders import AttentionPool

    rng = np.random.RandomState(seed)
    b, t, h, a = 6, 7, 32, 16
    states = rng.randn(b, t, h).astype(np.float32)
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[2] = 0
    params = {"proj": {"kernel": (rng.randn(h, a) / np.sqrt(h)).astype(
                  np.float32),
                       "bias": (rng.randn(a) * 0.5).astype(np.float32)},
              "score": {"kernel": rng.randn(a, 1).astype(np.float32)}}
    cot = rng.randn(b, h).astype(np.float32)

    def jloss(p, x, dt):
        out = JaxPool(attn_dim=a, dtype=dt).apply(
            {"params": p}, x.astype(dt), jnp.asarray(lengths))
        return jnp.sum(out.astype(jnp.float32) * cot)

    want, want32 = ({"weight": g[0]["proj"]["kernel"],
                     "bias": g[0]["proj"]["bias"],
                     "score": g[0]["score"]["kernel"], "states": g[1]}
                    for g in (jax.grad(jloss, argnums=(0, 1))(
                        params, jnp.asarray(states), dt)
                        for dt in (jnp.bfloat16, jnp.float32)))
    pool = AttentionPool(h, attn_dim=a, dtype=BF16)
    with torch.no_grad():
        pool.proj.weight.copy_(_torch(params["proj"]["kernel"].T))
        pool.proj.bias.copy_(_torch(params["proj"]["bias"]))
        pool.score.weight.copy_(_torch(params["score"]["kernel"].T))
    x = _torch(states).to(BF16).requires_grad_()
    out = pool(x, _torch(lengths))
    assert out.dtype == BF16
    (out.float() * _torch(cot)).sum().backward()
    got = {"weight": pool.proj.weight.grad.T, "bias": pool.proj.bias.grad,
           "score": pool.score.weight.grad.T, "states": x.grad}
    spread = {k: _rel_l2(want[k], want32[k]) for k in want}
    assert max(spread.values()) <= DETERMINED, spread
    share = {k: _rel_l2(got[k], want[k]) / (GRAD_RL2 + 3 * spread[k])
             for k in want}
    assert max(share.values()) <= 1.0, share


# ---- rank counting: K4's lowp branch ---------------------------------------


def test_rank_counts_bf16_precision_matches_pallas():
    """Small integers (exact in bf16) as in tests/test_pallas.py, plus a
    perturbation below bf16's resolution: precision="bfloat16" must round
    it away (so the counts equal the integer rows' exact counts, ties
    included) while float32 sees it. Exact equality with JAX's lowp."""
    rng = np.random.RandomState(7)
    q, n, d = 40, 200, 16
    qi = rng.randint(-3, 4, size=(q, d)).astype(np.float32)
    gi = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
    pos_idx = rng.randint(0, n, size=q).astype(np.int32)
    pos = (qi * gi[pos_idx]).sum(1).astype(np.float32)
    gpert = gi + (rng.rand(n, d).astype(np.float32) * 2**-12)
    gpert[gi == 0] = 0.0
    want = np.asarray(pallas_rank_counts(
        jnp.asarray(qi), jnp.asarray(gpert), jnp.asarray(pos),
        pos_idx=jnp.asarray(pos_idx), precision="bfloat16"))
    exact = 1 + ((qi @ gi.T > pos[:, None])
                 & (np.arange(n)[None, :] != pos_idx[:, None])).sum(1)
    np.testing.assert_array_equal(want, exact)
    args = (torch.from_numpy(qi), torch.from_numpy(gpert),
            torch.from_numpy(pos))
    got = rankcount_kernel.rank_counts(*args, pos_idx=torch.from_numpy(
        pos_idx), precision="bfloat16")
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = rankcount_kernel.rank_counts(*args, pos_idx=torch.from_numpy(
        pos_idx))
    assert (f32.numpy() != want).any()  # the perturbation counts in f32
    with pytest.raises(ValueError):
        rankcount_kernel.violation_counts(*args, precision="float16")


def test_violation_counts_takes_bf16_operands_as_pallas():
    """bf16 ``queries`` / ``gallery`` go into the lowp count as they are:
    the port's counts equal JAX's ``pallas_violation_counts`` on the same
    bf16 arrays (Pallas in interpret mode), and their f32 copies count the
    same. Values are multiples of 2**-6 below 2 (exact in bf16), so every
    sum of products is exact in f32 whatever its order; with exact ties
    with the positive, a NaN positive, invalid rows, an out-of-range
    pos_idx and a D that is not a multiple of 8."""
    rng = np.random.RandomState(11)
    q, n, d = 24, 150, 20
    qv = (rng.randint(-127, 128, (q, d)) / 64).astype(np.float32)
    gv = (rng.randint(-127, 128, (n, d)) / 64).astype(np.float32)
    pos_idx = rng.randint(0, n, q).astype(np.int32)
    gv[[3, 90]] = gv[pos_idx[0]]  # two rows tie with query 0's positive
    pos = (qv * gv[pos_idx]).sum(1).astype(np.float32)
    pos_idx[2] = n + 3  # out of range: nothing excluded
    pos[4] = np.nan
    valid = rng.rand(n) > 0.2
    want = np.asarray(pallas_violation_counts(
        jnp.asarray(qv, jnp.bfloat16), jnp.asarray(gv, jnp.bfloat16),
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(pos_idx),
        precision="bfloat16"))
    assert want[4] == 0
    args = (torch.from_numpy(pos), torch.from_numpy(valid),
            torch.from_numpy(pos_idx))
    tq, tg = torch.from_numpy(qv).to(BF16), torch.from_numpy(gv).to(BF16)
    got = rankcount_kernel.violation_counts(tq, tg, *args,
                                            precision="bfloat16")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = rankcount_kernel.violation_counts(tq.float(), tg.float(), *args,
                                            precision="bfloat16")
    np.testing.assert_array_equal(f32.numpy(), want)


# ---- the bf16 serving path -------------------------------------------------


def test_bf16_serving_path():
    """encode_gallery_device stores a bf16 gallery; validate_metrics gives
    the same metrics dense and streaming (both rank in f32 from the same
    bf16 values); the bf16-precision rank count agrees on these
    low-resolution values; Retriever answers both directions with the
    f32-accumulated top-k of the bf16 gallery, bf16 frames as queries."""
    _, _, pm, _, _ = _bf16_models("full")
    batches = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                        DataConfig(**DATA), shuffle=False))
    v, p, valid = encode_gallery_device(pm, batches)
    assert v.dtype == p.dtype == BF16 and int(valid.sum()) == 12
    dense = validate_metrics(pm, batches, streaming=False)
    stream = validate_metrics(pm, batches, streaming=True)
    assert dense == stream
    lowp = streaming_bidirectional_metrics(v, p, valid=valid,
                                           precision="bfloat16")
    assert {k: float(x) for k, x in lowp.items()} == stream
    host = encode_data(pm, batches)
    assert host[0].dtype == np.float32 and host[0].shape == (12, 32)
    np.testing.assert_array_equal(host[0], v[valid].float().numpy())
    q = batches[0]
    for side, query in (("video", lambda r: r.retrieve(
            q.words, q.word_len, q.sent_len, k=5)),
            ("text", lambda r: r.retrieve_video(
                q.frames, q.frame_len, q.clip_len, k=5))):
        r = Retriever(pm)
        r.build_gallery(encoded=(v, p, valid), side=side)
        scores, idx = query(r)
        with torch.no_grad():
            qe = (pm.encode_text(*[torch.as_tensor(a) for a in (
                q.words, q.word_len, q.sent_len)])[0] if side == "video"
                else pm.encode_video(q.frames, torch.as_tensor(q.frame_len),
                                     torch.as_tensor(q.clip_len))[0])
        gallery = v if side == "video" else p
        sims = qe.float() @ gallery.float().T
        sims = torch.where(valid[None, :], sims, float("-inf"))
        want_s, want_i = topk_lowest_index(sims, 5)
        np.testing.assert_array_equal(idx, want_i.numpy())
        np.testing.assert_array_equal(scores, want_s.numpy())


def pick_disagreements(name: str, seed: int) -> dict[str, int]:
    """For one init seed: the queries (of all four pick lists) whose pick
    differs between the port's and JAX's bf16 models, and between JAX's
    bf16 and f32 models, on the same weights and batch."""
    jm, params, pm, jb, pb = _bf16_models(name, seed)
    jm32 = JaxCMHSE(cfg=dataclasses.replace(jm.cfg, dtype="float32"),
                    vocab_size=DS["vocab_size"])
    with torch.no_grad():
        port = port_hardest_negatives(pm(pb), pb, LossConfig())
    jax16 = jax_hardest_negatives(jm.apply({"params": params}, jb), jb.valid)
    jax32 = jax_hardest_negatives(jm32.apply({"params": params}, jb),
                                  jb.valid)
    live = sum(int((p >= 0).sum()) for p in jax16)
    return dict(queries=live,
                port_vs_jax=sum(int((a != b).sum())
                                for a, b in zip(port, jax16)),
                jax_bf16_vs_f32=sum(int((a != b).sum())
                                    for a, b in zip(jax16, jax32)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args()
    for name in ("hier", "full"):
        rows = [pick_disagreements(name, s) for s in range(args.seeds)]
        n_q = sum(r["queries"] for r in rows)
        for key in ("port_vs_jax", "jax_bf16_vs_f32"):
            n = sum(r[key] for r in rows)
            seeds = sum(r[key] > 0 for r in rows)
            print(f"{name} {key}: {n} of {n_q} picks differ, in {seeds} of "
                  f"{args.seeds} seeds")


if __name__ == "__main__":
    main()
