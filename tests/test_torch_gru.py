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
