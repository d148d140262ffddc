"""The port's trainable GRU against the JAX package's, on the CPU: the plain
gate-saving forward and BPTT (the references of the ``gru_fwd`` save_gates /
with_h0 variants and of ``gru_bwd``) against ``pallas_gru_sequence`` /
``_gru_bwd_pallas`` (Pallas, interpret mode), and ``TrainableGRU`` through
autograd against ``jax.grad`` of ``pallas_gru_trainable``, with and without
h0, at the JAX package's own band (rtol 2e-4, atol 2e-5); the decoder and
the bidirectional ``MaskedGRU`` against JAX's with carried weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmhse_tpu.models.cmhse import ReconstructionDecoder as JaxDecoder
from cmhse_tpu.models.gru import MaskedGRU as JaxMaskedGRU
from cmhse_tpu.ops.pallas_gru import pallas_gru_sequence
from cmhse_tpu.ops.pallas_gru_grad import _gru_bwd_pallas, pallas_gru_trainable
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models import MaskedGRU, ReconstructionDecoder
from cmhse_tpu_torch.models.gru import gru_input_projection
from cmhse_tpu_torch.ops import gru_kernel

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-5)

# tests/test_pallas_gru_grad.py's shapes, plus length-0 rows
SHAPES = [
    (6, 5, 8, 16, ()),
    (140, 7, 12, 8, ()),    # batch not a multiple of the backward chunk
    (10, 1, 8, 16, ()),     # T = 1
    (9, 6, 5, 8, (0, 4, 8)),
]


def _setup(b, t, d, h, zero_rows=(), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[list(zero_rows)] = 0
    w_i = (rng.randn(d, 3 * h) * 0.15).astype(np.float32)
    w_h = (rng.randn(h, 3 * h) * 0.15).astype(np.float32)
    b_i = (rng.randn(3 * h) * 0.1).astype(np.float32)
    b_h = (rng.randn(3 * h) * 0.1).astype(np.float32)
    h0 = (rng.randn(b, h) * 0.5).astype(np.float32)
    co = rng.randn(b, t, h).astype(np.float32)
    cf = rng.randn(b, h).astype(np.float32)
    return [x, lengths, w_i, w_h, b_i, b_h], h0, co, cf


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,d,h,zero_rows", SHAPES)
def test_plain_gates_and_bptt_match_pallas(seeded, b, t, d, h, zero_rows):
    args, h0, co, cf = _setup(b, t, d, h, zero_rows)
    jh0 = jnp.asarray(h0) if seeded else None
    jargs = [jnp.asarray(a) for a in args]
    j_outs, j_final, j_gates, j_raw = pallas_gru_sequence(
        *jargs, save_gates=True, h0=jh0)
    j_dxw, j_dhn, j_db, _, j_dh0 = _gru_bwd_pallas(
        j_gates, j_raw, jnp.asarray(co), jnp.asarray(cf), jargs[1],
        jargs[3], h0=jh0)

    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy, args)
    th0 = torch.from_numpy(h0) if seeded else None
    xw = gru_input_projection(x, w_i, b_i)
    outs, final, gates = gru_kernel.gru_recurrence_plain(
        xw, w_h, b_h, lengths, th0, save_gates=True)
    np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), **TOL)
    live = np.arange(t)[None, :] < args[1][:, None]  # the gates kernels read
    np.testing.assert_allclose(
        gates.numpy()[live],
        np.swapaxes(np.asarray(j_gates), 0, 1)[:b][live], **TOL)

    dxw, dhn, db, dh0 = gru_kernel.gru_backward_plain(
        gates, outs, lengths, w_h, torch.from_numpy(co),
        torch.from_numpy(cf), th0)
    np.testing.assert_allclose(
        dxw.numpy(), np.swapaxes(np.asarray(j_dxw), 0, 1)[:b], **TOL)
    np.testing.assert_allclose(
        dhn.numpy(), np.swapaxes(np.asarray(j_dhn), 0, 1)[:b], **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), **TOL)
    if seeded:
        np.testing.assert_allclose(dh0.numpy(), np.asarray(j_dh0)[:b], **TOL)
    # a length-0 row passes every cotangent through to dh0
    for r in zero_rows:
        np.testing.assert_allclose(dh0[r].numpy(), cf[r] + co[r].sum(0),
                                   rtol=1e-6, atol=1e-6)
        assert not dxw[r].any() and not dhn[r].any()


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,t,d,h,zero_rows", SHAPES)
def test_trainable_gru_grads_match_jax(seeded, b, t, d, h, zero_rows):
    args, h0, co, cf = _setup(b, t, d, h, zero_rows, seed=1)
    names = ["dx", "dW_i", "dW_h", "db_i", "db_h"] + (["dh0"] if seeded
                                                      else [])

    def jloss(x, w_i, w_h, b_i, b_h, h0_):
        outs, final = pallas_gru_trainable(x, jnp.asarray(args[1]), w_i, w_h,
                                           b_i, b_h, h0=h0_)
        return jnp.sum(outs * co) + jnp.sum(final * cf)

    diff = [jnp.asarray(args[i]) for i in (0, 2, 3, 4, 5)]
    jh0 = jnp.asarray(h0) if seeded else None
    argnums = tuple(range(6 if seeded else 5))
    want = jax.grad(jloss, argnums=argnums)(*diff, jh0)

    x, w_i, w_h, b_i, b_h = [torch.from_numpy(args[i]).requires_grad_()
                             for i in (0, 2, 3, 4, 5)]
    th0 = torch.from_numpy(h0).requires_grad_() if seeded else None
    xw = gru_input_projection(x, w_i, b_i)
    outs, final = gru_kernel.gru_recurrence(xw, w_h, b_h,
                                            torch.from_numpy(args[1]), th0)
    assert type(outs.grad_fn).__name__ == "TrainableGRUBackward"
    loss = (outs * torch.from_numpy(co)).sum() + (final
                                                  * torch.from_numpy(cf)).sum()
    loss.backward()
    got = [x.grad, w_i.grad, w_h.grad, b_i.grad, b_h.grad]
    got += [th0.grad] if seeded else []
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def test_final_only_loss_gets_no_douts():
    """A readout of the final state alone leaves ``douts`` unmaterialised
    (None in the backward); the gradients still match JAX's."""
    args, h0, _, cf = _setup(7, 5, 6, 8, (2,), seed=2)

    def jloss(w_h, h0_):
        _, final = pallas_gru_trainable(*[jnp.asarray(a) for a in args[:3]],
                                        w_h, *[jnp.asarray(a)
                                               for a in args[4:]], h0=h0_)
        return jnp.sum(final * cf)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(args[3]),
                                            jnp.asarray(h0))
    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy, args)
    w_h.requires_grad_()
    th0 = torch.from_numpy(h0).requires_grad_()
    _, final = gru_kernel.gru_recurrence(gru_input_projection(x, w_i, b_i),
                                         w_h, b_h, lengths, th0)
    (final * torch.from_numpy(cf)).sum().backward()
    np.testing.assert_allclose(w_h.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(th0.grad.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(th0.grad[2].numpy(), cf[2], rtol=1e-6)


def test_no_grad_takes_the_encode_forward():
    args, _, _, _ = _setup(5, 4, 6, 8)
    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy, args)
    w_h.requires_grad_()
    xw = gru_input_projection(x, w_i, b_i)
    with torch.no_grad():
        outs, _ = gru_kernel.gru_recurrence(xw, w_h, b_h, lengths)
    assert outs.grad_fn is None
    want, _ = gru_kernel.gru_recurrence_plain(xw, w_h.detach(), b_h, lengths)
    assert torch.equal(outs, want)


def test_decoder_matches_jax():
    """ReconstructionDecoder at T = 8 < 16: JAX takes its scan there, the
    port its seeded recurrence; outputs and every parameter gradient
    agree."""
    rng = np.random.RandomState(13)
    b, t, e, h = 6, 8, 12, 16
    high = rng.randn(b, e).astype(np.float32)
    low = rng.randn(b, t, e).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[1] = 0
    co = rng.randn(b, t, e).astype(np.float32)
    jdec = JaxDecoder(embed_size=e, rnn_hidden=h)
    params = jdec.init(jax.random.PRNGKey(0), high, low, lengths)["params"]

    def jloss(p, hi, lo):
        return jnp.sum(jdec.apply({"params": p}, hi, lo, lengths) * co)

    jout = jdec.apply({"params": params}, high, low, lengths)
    jgrads, jd_high, jd_low = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(high), jnp.asarray(low))

    dec = ReconstructionDecoder(e, h)
    dec.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    th = torch.from_numpy(high).requires_grad_()
    tl = torch.from_numpy(low).requires_grad_()
    out = dec(th, tl, torch.from_numpy(lengths))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(co)).sum().backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for k, p in dec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jd_high), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jd_low), **TOL)


def test_bidirectional_masked_gru_grads_match_jax():
    b, t, d, h = 7, 6, 10, 12
    rng = np.random.RandomState(5)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([0, 1, 6, 3, 5, 2, 6], np.int32)
    co = rng.randn(b, t, 2 * h).astype(np.float32)
    jgru = JaxMaskedGRU(features=h, bidirectional=True)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(lengths))["params"]

    def jloss(p, x_):
        outs, final = jgru.apply({"params": p}, x_, jnp.asarray(lengths))
        return jnp.sum(outs * co) + jnp.sum(final ** 2)

    jgrads, jdx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    gru = MaskedGRU(d, h, bidirectional=True)
    gru.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tx = torch.from_numpy(x).requires_grad_()
    outs, final = gru(tx, torch.from_numpy(lengths))
    ((outs * torch.from_numpy(co)).sum() + (final ** 2).sum()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for k, p in gru.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)


# lengths: random (unsorted); ties; past T (T = 6); every length 0; one row
@pytest.mark.parametrize("lengths", [
    [3, 0, 6, 1, 5, 2, 6, 4, 0, 3],
    [2, 4, 2, 4, 2, 0, 4, 0, 2],
    [9, 6, 12, 0, 7, 6, 3],
    [0, 0, 0, 0],
    [5],
])
def test_live_row_order_puts_the_live_rows_first(lengths):
    """gru_bwd's product walks a prefix of ``live_row_order``: at every
    step t the first n_t entries are exactly the rows with t < length, and
    equal lengths keep row order, so the order depends only on lengths."""
    lens = torch.tensor(lengths, dtype=torch.int32)
    order = gru_kernel.live_row_order(lens)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(len(lengths)))
    for t in range(max(lengths) + 2):
        live = [b for b, n in enumerate(lengths) if t < n]
        assert sorted(order[:len(live)].tolist()) == live
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        assert (lengths[a], -a) > (lengths[b], -b)


@pytest.mark.parametrize("seeded", [False, True])
def test_padding_to_a_multiple_of_4_is_exact(seeded):
    """The CUDA wrapper's padding of the backward at H = 30 to 32
    (``pad_backward_operands`` / ``unpad_backward_results``) through the
    plain BPTT: equal to the unpadded call within 1e-6 (the padded units'
    zero gates give them zero gradient), and to the JAX package's Pallas
    backward at H = 30 within the file's band."""
    b, t, d, h = 9, 6, 5, 30
    args, h0, co, cf = _setup(b, t, d, h, zero_rows=(4,), seed=3)
    jh0 = jnp.asarray(h0) if seeded else None
    jargs = [jnp.asarray(a) for a in args]
    _, _, j_gates, j_raw = pallas_gru_sequence(*jargs, save_gates=True,
                                               h0=jh0)
    j_dxw, j_dhn, j_db, _, j_dh0 = _gru_bwd_pallas(
        j_gates, j_raw, jnp.asarray(co), jnp.asarray(cf), jargs[1],
        jargs[3], h0=jh0)

    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy, args)
    th0 = torch.from_numpy(h0) if seeded else None
    xw = gru_input_projection(x, w_i, b_i)
    outs, _, gates = gru_kernel.gru_recurrence_plain(
        xw, w_h, b_h, lengths, th0, save_gates=True)
    douts, dfinal = torch.from_numpy(co), torch.from_numpy(cf)
    hp = gru_kernel.padded_hidden(h)
    padded = gru_kernel.pad_backward_operands(gates, outs, w_h, douts,
                                              dfinal, th0, hp)
    assert padded[0].shape[-1] == 4 * hp
    got = gru_kernel.unpad_backward_results(
        gru_kernel.gru_backward_plain(padded[0], padded[1], lengths,
                                      padded[2], padded[3], padded[4],
                                      padded[5]), h)
    want = gru_kernel.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, th0)
    # within 1e-6 of each entry's size: the bias sums reduce over a wider
    # [B, T, 4 x 32] block, so their f32 sums may run in another order
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    dxw, dhn, db, dh0 = got
    np.testing.assert_allclose(
        dxw.numpy(), np.swapaxes(np.asarray(j_dxw), 0, 1)[:b], **TOL)
    np.testing.assert_allclose(
        dhn.numpy(), np.swapaxes(np.asarray(j_dhn), 0, 1)[:b], **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), **TOL)
    if seeded:
        np.testing.assert_allclose(dh0.numpy(), np.asarray(j_dh0)[:b], **TOL)
