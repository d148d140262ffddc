"""The port's GRU against the JAX package's: the plain recurrence (the
reference of the ``gru_fwd`` CUDA kernel) against ``pallas_gru_sequence``
(Pallas, interpret mode on the CPU) and the ``lax.scan`` GRU, f32, within
1e-5; ``MaskedGRU`` with carried JAX weights, bidirectional included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmhse_tpu.models.gru import MaskedGRU as JaxMaskedGRU
from cmhse_tpu.models.gru import flip_padded as jax_flip_padded
from cmhse_tpu.models.gru import gru_sequence as jax_gru_sequence
from cmhse_tpu.models.gru import masked_mean as jax_masked_mean
from cmhse_tpu.ops.pallas_gru import pallas_gru_sequence
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models.gru import (MaskedGRU, flip_padded,
                                        gru_sequence, masked_mean)
from cmhse_tpu_torch.ops import cuda_lib, gru_kernel

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(b, t, d, h, seed=0, zero_rows=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[list(zero_rows)] = 0
    w_i = (rng.randn(d, 3 * h) * 0.1).astype(np.float32)
    w_h = (rng.randn(h, 3 * h) * 0.1).astype(np.float32)
    b_i = (rng.randn(3 * h) * 0.1).astype(np.float32)
    b_h = (rng.randn(3 * h) * 0.1).astype(np.float32)
    return x, lengths, w_i, w_h, b_i, b_h


@pytest.mark.parametrize("b,t,d,h,zero_rows", [
    (8, 6, 12, 16, ()),          # tiny (tests/test_pallas_gru.py)
    (300, 5, 8, 8, ()),          # batch not a multiple of the chunk
    (9, 7, 5, 16, (0, 4, 8)),    # length-0 rows
])
def test_plain_gru_matches_pallas_and_scan(b, t, d, h, zero_rows):
    args = _setup(b, t, d, h, zero_rows=zero_rows)
    p_outs, p_final = pallas_gru_sequence(*map(jnp.asarray, args))
    s_outs, s_final = jax_gru_sequence(*map(jnp.asarray, args))
    outs, final = gru_sequence(*map(torch.from_numpy, args))
    for want_outs, want_final in ((p_outs, p_final), (s_outs, s_final)):
        np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), **TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                                   **TOL)
    for r in zero_rows:
        assert not final[r].any()


def test_wrapper_on_cpu_is_the_plain_version():
    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy,
                                         _setup(6, 4, 5, 8, seed=3))
    xw = x @ w_i + b_i
    before = cuda_lib.launch_count("gru_fwd")
    got = gru_kernel.gru_recurrence(xw, w_h, b_h, lengths)
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths)
    assert cuda_lib.launch_count("gru_fwd") == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_refuses_other_devices_and_shapes():
    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy,
                                         _setup(4, 3, 5, 8, seed=4))
    xw = x @ w_i + b_i
    with pytest.raises(ValueError):  # no silent path for a non-CPU device
        gru_kernel.gru_recurrence(xw.to("meta"), w_h.to("meta"),
                                  b_h.to("meta"), lengths.to("meta"))
    with pytest.raises(ValueError):
        gru_kernel.gru_recurrence(xw, w_h[:, :-1], b_h, lengths)
    with pytest.raises(ValueError):
        gru_kernel.gru_recurrence(xw, w_h, b_h, lengths[:-1])


@pytest.mark.parametrize("bidirectional", [False, True])
def test_masked_gru_with_jax_weights(bidirectional):
    b, t, d, h = 7, 6, 10, 12
    rng = np.random.RandomState(5)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([0, 1, 6, 3, 5, 2, 6], np.int32)
    jgru = JaxMaskedGRU(features=h, bidirectional=bidirectional)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(lengths))["params"]
    want_outs, want_final = jgru.apply({"params": params}, jnp.asarray(x),
                                       jnp.asarray(lengths))
    gru = MaskedGRU(d, h, bidirectional)
    gru.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        outs, final = gru(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), **TOL)


def test_flip_padded_and_masked_mean_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(5, 7, 3).astype(np.float32)
    lengths = np.array([0, 7, 3, 1, 5], np.int32)
    np.testing.assert_array_equal(
        flip_padded(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_flip_padded(jnp.asarray(x), jnp.asarray(lengths))))
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(lengths))),
        rtol=1e-6, atol=1e-6)


def test_init_is_seeded_and_symmetric():
    a = MaskedGRU(4, 16, generator=torch.Generator().manual_seed(1))
    b = MaskedGRU(4, 16, generator=torch.Generator().manual_seed(1))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.abs().max() <= 0.25 and p.min() < 0 < p.max()


@pytest.mark.parametrize("b,t,seed", [(1, 1, 0), (9, 7, 1), (37, 4, 2),
                                      (600, 9, 3)])
def test_live_counts_and_order_match_numpy(b, t, seed):
    """The streamed gru_fwd's host side: ``live_counts`` against a numpy
    count of t < length at each step (length 0 and lengths past T
    included), and the prefix of ``live_row_order`` that long holds exactly
    the step's live rows."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, t + 3, b).astype(np.int32)
    lengths[::5] = 0
    counts = gru_kernel.live_counts(torch.from_numpy(lengths), t)
    want = np.array([(lengths > s).sum() for s in range(t)])
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (t,)
    np.testing.assert_array_equal(counts.numpy(), want)
    order = gru_kernel.live_row_order(torch.from_numpy(lengths)).numpy()
    assert sorted(order.tolist()) == list(range(b))
    for s in range(t):
        assert set(order[:want[s]]) == set(np.flatnonzero(lengths > s))


@pytest.mark.parametrize("seeded,save_gates", [(False, False), (True, True)])
def test_padding_to_a_multiple_of_4_is_exact(seeded, save_gates):
    """The CUDA wrapper's padding of H = 30 to 32 (``pad_forward_operands``
    / ``unpad_forward_results``), run through the plain recurrence: equal
    to the unpadded call within 1e-6, and to JAX's scan GRU at H = 30."""
    b, t, d, h = 9, 6, 7, 30
    args = _setup(b, t, d, h, seed=8, zero_rows=(2,))
    x, lengths, w_i, w_h, b_i, b_h = map(torch.from_numpy, args)
    h0 = (torch.from_numpy(np.random.RandomState(9).randn(b, h)
                           .astype(np.float32)) if seeded else None)
    xw = x @ w_i + b_i
    hp = gru_kernel.padded_hidden(h)
    assert hp == 32
    padded = gru_kernel.pad_forward_operands(xw, w_h, b_h, h0, hp)
    assert padded[0].shape[-1] == 3 * hp and padded[1].shape == (hp, 3 * hp)
    got = gru_kernel.unpad_forward_results(
        gru_kernel.gru_recurrence_plain(padded[0], padded[1], padded[2],
                                        lengths, padded[3], save_gates), h)
    want = gru_kernel.gru_recurrence_plain(xw, w_h, b_h, lengths, h0,
                                           save_gates)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=1e-6)
    if not seeded:
        s_outs, s_final = jax_gru_sequence(*map(jnp.asarray, args))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(s_outs), **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(s_final),
                                   **TOL)


# ---- the products over the live row-steps (ops/live_gemm.py) ---------------
# The plain versions of the kernel's two forms, on the CPU: lengths 0, T and
# past T; D of the cells' layers, 500 (frames), 300 (words) and 1,024 (the
# high-level GRUs and the decoders).
LIVE_D = [500, 300, 1024]


def _live_setup(d, h=8, t=5, seed=0):
    """x, w_i, b_i, g and dhn (zero at dead row-steps, as gru_bwd gives
    them), outs, h0, lengths and the dead mask."""
    rng = np.random.RandomState(seed + d)
    lengths = np.array([0, t, 3, 1, t + 2, 2, 4], np.int32)
    b = lengths.size
    arrays = [rng.randn(*shape).astype(np.float32) for shape in (
        (b, t, d), (d, 3 * h), (3 * h,), (b, t, 3 * h), (b, t, h),
        (b, t, h), (b, h))]
    x, w_i, b_i, g, dhn, outs, h0 = map(torch.from_numpy, arrays)
    lengths = torch.from_numpy(lengths)
    dead = ~(torch.arange(t)[None, :] < lengths[:, None])
    g[dead], dhn[dead] = 0.0, 0.0
    return x, w_i, b_i, g, dhn, outs, h0, lengths, dead


def _dense_dw_h(outs, g, dhn, h0):
    """TrainableGRU's dense dW_h: h_prev^T [dr', dz', dhn] over every
    row-step."""
    b, t, h = outs.shape
    first = (torch.zeros(b, h) if h0 is None else h0)[:, None]
    h_prev = torch.cat([first, outs[:, :-1]], dim=1).reshape(b * t, h)
    return torch.cat([h_prev.T @ g[..., :2 * h].reshape(b * t, -1),
                      h_prev.T @ dhn.reshape(b * t, h)], dim=1)


@pytest.mark.parametrize("d", LIVE_D)
def test_live_gemm_plain_forms_match_dense_on_live_rows(d):
    """The row form equals the dense product on live rows and is zero on
    dead ones (so dX is, as the dense dX of zero gradients is); the
    reduction form equals the dense dW_i, db_i and dW_h (with and without
    h0); on CPU tensors the wrappers are the plain versions and launch
    nothing."""
    from cmhse_tpu_torch.ops import live_gemm as lg

    x, w_i, b_i, g, dhn, outs, h0, lengths, dead = _live_setup(d)
    b, t, _ = x.shape
    xw = lg.rows_product_plain(x, w_i, b_i, lengths)
    torch.testing.assert_close(xw[~dead], (x @ w_i + b_i)[~dead], **TOL)
    assert not xw[dead].any()
    dx = lg.rows_product_plain(g, w_i, None, lengths, w_nk=True)
    torch.testing.assert_close(dx, g @ w_i.T, **TOL)
    assert not dx[dead].any()
    dw_i, db_i = lg.rows_reduce_plain(x, g, lengths, column_sums=True)
    torch.testing.assert_close(dw_i, x.reshape(b * t, d).T
                               @ g.reshape(b * t, -1), **TOL)
    torch.testing.assert_close(db_i, g.sum(dim=(0, 1)), **TOL)
    for s0 in (None, h0):
        dw_h, none = lg.rows_reduce_plain(outs, g, lengths, g_cols=16,
                                          g_tail=dhn, shift=True, h0=s0)
        assert none is None
        torch.testing.assert_close(dw_h, _dense_dw_h(outs, g, dhn, s0),
                                   **TOL)
    before = sum(cuda_lib.launches.values())
    assert torch.equal(lg.rows_product(x, w_i, b_i, lengths, ()), xw)
    assert torch.equal(lg.rows_product(g, w_i, None, lengths, (), w_nk=True,
                                       zero_dead=True), dx)
    got = lg.rows_reduce(x, g, lengths, (), column_sums=True)
    assert torch.equal(got[0], dw_i) and torch.equal(got[1], db_i)
    assert sum(cuda_lib.launches.values()) == before


@pytest.mark.parametrize("d", LIVE_D)
def test_live_gemm_plain_forms_never_read_dead_rows(d):
    """NaN in the dead rows of x, g (dxw), dhn and outs changes no bit of
    either form: the live rows of xw, dX (zero on dead rows), dW_i, db_i
    and dW_h."""
    from cmhse_tpu_torch.ops import live_gemm as lg

    x, w_i, b_i, g, dhn, outs, h0, lengths, dead = _live_setup(d, seed=1)

    def forms(x, g, dhn, outs):
        return [lg.rows_product_plain(x, w_i, b_i, lengths)[~dead],
                lg.rows_product_plain(g, w_i, None, lengths, w_nk=True),
                *lg.rows_reduce_plain(x, g, lengths, column_sums=True),
                lg.rows_reduce_plain(outs, g, lengths, g_cols=16,
                                     g_tail=dhn, shift=True, h0=h0)[0]]

    clean = forms(x, g, dhn, outs)
    poisoned = [z.clone() for z in (x, g, dhn, outs)]
    for z in poisoned:
        z[dead] = float("nan")
    for a, c in zip(forms(*poisoned), clean):
        assert torch.equal(a, c)


def _route_live_products_on_the_cpu(monkeypatch) -> list:
    """Send the model's f32 GRU products through the live row-step path on
    the CPU, where they take the plain versions: the card's routing, plan
    and masks, checked here. Returns the forms called, as they are."""
    from cmhse_tpu_torch.ops import live_gemm

    monkeypatch.setattr(live_gemm, "takes",
                        lambda x: x.dtype == torch.float32)
    called = []
    for name in ("rows_product", "rows_reduce"):
        def form(*args, _real=getattr(live_gemm, name), _name=name, **kw):
            called.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(live_gemm, name, form)
    return called


def _grads_of(module, inputs, outputs):
    loss = sum((o.float() * torch.linspace(-1, 1, o.numel()).reshape(
        o.shape)).sum() for o in outputs)
    return torch.autograd.grad(loss, [*inputs, *module.parameters()])


@pytest.mark.parametrize("d,bidirectional", [(500, False), (300, True),
                                             (1024, False)])
def test_masked_gru_live_products_match_dense(monkeypatch, d, bidirectional):
    """MaskedGRU through the live row-step products (the card's f32 path,
    its plain versions here) against the dense products: the same
    outputs and the same gradients of x and of every parameter. (A
    bidirectional layer's flip takes lengths up to T.)"""
    x, *_, lengths, _ = _live_setup(d, seed=2)
    lengths = lengths.clamp(max=x.shape[1])
    x.requires_grad_()
    results, called = [], []
    for live in (False, True):
        if live:
            called = _route_live_products_on_the_cpu(monkeypatch)
        gru = MaskedGRU(d, 8, bidirectional,
                        generator=torch.Generator().manual_seed(d))
        outs = gru(x, lengths)
        results.append((outs, _grads_of(gru, [x], outs)))
    # each direction: the projection and dX, dW_i and dW_h
    assert sorted(called) == ["rows_product"] * (2 + 2 * bidirectional) \
        + ["rows_reduce"] * (2 + 2 * bidirectional)
    (dense_outs, dense_grads), (outs, grads) = results
    for a, w in zip(outs, dense_outs):
        torch.testing.assert_close(a, w, **TOL)
    for a, w in zip(grads, dense_grads):
        torch.testing.assert_close(a, w, **TOL)


def test_decoder_live_products_match_dense(monkeypatch):
    """The reconstruction decoder (seeded h0, D = E = 1,024, lengths 0 and
    T) through the live row-step products against the dense ones."""
    from cmhse_tpu_torch.models import ReconstructionDecoder

    rng = np.random.RandomState(3)
    high = torch.from_numpy(rng.randn(5, 1024).astype(np.float32))
    low = torch.from_numpy(rng.randn(5, 6, 1024).astype(np.float32))
    lengths = torch.tensor([6, 0, 2, 6, 4], dtype=torch.int32)
    high.requires_grad_()
    low.requires_grad_()
    results, called = [], []
    for live in (False, True):
        if live:
            called = _route_live_products_on_the_cpu(monkeypatch)
        dec = ReconstructionDecoder(1024, 8,
                                    generator=torch.Generator().manual_seed(4))
        pred = dec(high, low, lengths)
        results.append((pred, _grads_of(dec, [high, low], [pred])))
    assert sorted(called) == ["rows_product"] * 2 + ["rows_reduce"] * 2
    (dense_pred, dense_grads), (pred, grads) = results
    torch.testing.assert_close(pred, dense_pred, **TOL)
    for a, w in zip(grads, dense_grads):
        torch.testing.assert_close(a, w, **TOL)
