"""The port's losses against the JAX package's, on the CPU: both variants of
``contrastive_loss`` and the fused loss (values and gradients) against
``contrastive_loss`` / ``pallas_contrastive_loss`` (Pallas in interpret
mode) with multi-positive masks and invalid rows, within 1e-5; the plain
two-direction ``simhinge`` maxima and argmax indices against the JAX
kernel's ``_simhinge_forward`` exactly; ``reconstruction_loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmhse_tpu.ops.loss import contrastive_loss as jax_contrastive_loss
from cmhse_tpu.ops.loss import positive_mask_from_ids as jax_positive_mask
from cmhse_tpu.ops.loss import reconstruction_loss as jax_recon_loss
from cmhse_tpu.ops.pallas_sim import _simhinge_forward, pallas_contrastive_loss
from cmhse_tpu_torch.ops import cuda_lib, simhinge_kernel
from cmhse_tpu_torch.ops.loss import (contrastive_loss, positive_mask_from_ids,
                                      reconstruction_loss)
from cmhse_tpu_torch.ops.simhinge_kernel import (
    fused_contrastive_loss_from_masks, simhinge_pair, simhinge_pair_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, d, seed, groups=None, invalid=()):
    """l2-normalized rows, a multi-positive mask from group ids (rows of one
    group are each other's positives) and a validity mask."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, d)
    p = a + 0.8 * rng.randn(b, d)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    ids = (np.arange(b) if groups is None
           else rng.randint(0, groups, b)).astype(np.int32)
    valid = np.ones(b, bool)
    valid[list(invalid)] = False
    return a.astype(np.float32), p.astype(np.float32), ids, valid


CASES = [
    (8, 16, None, ()),             # identity positives
    (24, 32, 9, (3, 17)),          # multi-positive groups, invalid rows
    (130, 16, 40, (0, 129)),       # past the JAX kernel's 128-row tile
]


@pytest.mark.parametrize("max_violation", [True, False])
@pytest.mark.parametrize("b,d,groups,invalid", CASES)
def test_contrastive_loss_and_grads_match_jax(max_violation, b, d, groups,
                                              invalid):
    a, p, ids, valid = _inputs(b, d, b + d, groups, invalid)

    def jloss(x, y):
        pos = jax_positive_mask(jnp.asarray(ids), jnp.asarray(ids))
        return jax_contrastive_loss(x, y, 0.2, max_violation, pos,
                                    jnp.asarray(valid))

    want, (wa, wp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(p))
    ta = torch.from_numpy(a).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    tids = torch.from_numpy(ids)
    got = contrastive_loss(ta, tp, 0.2, max_violation,
                           positive_mask_from_ids(tids, tids),
                           torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp), **TOL)


@pytest.mark.parametrize("b,d,groups,invalid", CASES)
def test_fused_loss_and_grads_match_pallas(b, d, groups, invalid):
    a, p, ids, valid = _inputs(b, d, 2 * b + d, groups, invalid)
    pos_np = ids[:, None] == ids[None, :]

    def jloss(x, y):
        return pallas_contrastive_loss(x, y, 0.2, jnp.asarray(pos_np),
                                       jnp.asarray(valid))

    want, (wa, wp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(p))
    ta = torch.from_numpy(a).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    before = cuda_lib.launch_count("simhinge")
    got = fused_contrastive_loss_from_masks(ta, tp, 0.2,
                                            torch.from_numpy(pos_np),
                                            torch.from_numpy(valid))
    got.backward()
    assert cuda_lib.launch_count("simhinge") == before  # plain version on the CPU
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp), **TOL)
    # the same value as the unfused max-violation loss
    ref = contrastive_loss(torch.from_numpy(a), torch.from_numpy(p), 0.2,
                           True, torch.from_numpy(pos_np),
                           torch.from_numpy(valid))
    np.testing.assert_allclose(float(got.detach()), float(ref), **TOL)


def _exact_rows(rng, n, d):
    """Rows of multiples of 2**-6: every product is exact in f32, so the
    maxima and their argmax cannot depend on the summation order."""
    return (np.round(rng.randn(n, d) * 8) / 64).astype(np.float32)


@pytest.mark.parametrize("b,d", [(8, 16), (130, 12), (300, 8)])
def test_plain_pass_matches_jax_kernel_exactly(b, d):
    rng = np.random.RandomState(b)
    a = _exact_rows(rng, b, d)
    p = _exact_rows(rng, b, d)
    p[5] = p[1]            # duplicate columns: ties go to the lowest index
    p[b - 1] = p[2]
    a[b - 2] = a[3]
    neg = rng.rand(b, b) > 0.3
    np.fill_diagonal(neg, False)
    neg[4] = False         # a row with no negative
    neg[:, 6] = False      # and a column with none
    want = [np.asarray(x) for x in _simhinge_forward(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(neg), 0.2)]
    ta, tp, tneg = map(torch.from_numpy, (a, p, neg))
    diag = torch.sum(ta * tp, dim=1)
    row_max, row_arg, col_max, col_arg = simhinge_pair(ta, tp, tneg, diag,
                                                       diag, 0.2)
    for got, w in zip((row_max, row_arg, col_max, col_arg), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert row_max[4] == simhinge_kernel.NEG_INF and row_arg[4] == 0
    assert col_max[6] == simhinge_kernel.NEG_INF and col_arg[6] == 0


def test_rowpass_refuses_bad_shapes_and_devices():
    a = torch.zeros(4, 3)
    neg = torch.ones(4, 4, dtype=torch.bool)
    diag = torch.zeros(4)
    with pytest.raises(ValueError):
        simhinge_pair(a, torch.zeros(4, 2), neg, diag, diag, 0.2)
    with pytest.raises(ValueError):
        simhinge_pair(a, torch.zeros(5, 3), neg, diag, diag, 0.2)
    with pytest.raises(ValueError):
        simhinge_pair(a, a, neg, torch.zeros(3), diag, 0.2)
    with pytest.raises(ValueError):
        simhinge_pair(a, a, neg, diag, torch.zeros(5), 0.2)
    with pytest.raises(ValueError):  # no silent path for a non-CPU device
        simhinge_pair(a.to("meta"), a.to("meta"), neg.to("meta"),
                      diag.to("meta"), diag.to("meta"), 0.2)
    got = simhinge_pair(a, a, neg, diag, diag, 0.2)
    want = simhinge_pair_plain(a, a, neg, diag, diag, 0.2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_reconstruction_loss_and_masks_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.randn(4, 5, 6).astype(np.float32)
    target = rng.randn(4, 5, 6).astype(np.float32)
    mask = rng.rand(4, 5) > 0.4
    want = jax_recon_loss(jnp.asarray(pred), jnp.asarray(target),
                          jnp.asarray(mask))
    got = reconstruction_loss(torch.from_numpy(pred),
                              torch.from_numpy(target),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = reconstruction_loss(torch.from_numpy(pred),
                                torch.from_numpy(target),
                                torch.zeros(4, 5, dtype=torch.bool))
    assert float(empty) == 0.0
    ids = np.array([3, 1, 3, -1], np.int32)
    np.testing.assert_array_equal(
        positive_mask_from_ids(torch.from_numpy(ids),
                               torch.from_numpy(ids)).numpy(),
        np.asarray(jax_positive_mask(jnp.asarray(ids), jnp.asarray(ids))))
