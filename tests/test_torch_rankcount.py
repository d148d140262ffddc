"""The port's rank counting against the JAX package's: the plain version of
the ``rankcount`` CUDA kernel against ``pallas_rank_counts`` (Pallas,
interpret mode on the CPU), counts exact, with ``gallery_valid``,
``pos_idx`` and a NaN positive; the dense ranks and metric reductions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmhse_tpu.ops import ranking as jax_ranking
from cmhse_tpu.ops.pallas_sim import pallas_rank_counts, pallas_violation_counts
from cmhse_tpu_torch.ops import cuda_lib
from cmhse_tpu_torch.ops import rankcount_kernel as rk
from cmhse_tpu_torch.ops import ranking

torch.set_num_threads(2)


def _inputs(q, n, d=32, seed=4):
    rng = np.random.RandomState(seed)
    queries = rng.randn(q, d).astype(np.float32)
    gallery = rng.randn(n, d).astype(np.float32)
    pos_idx = rng.randint(0, n, size=q).astype(np.int32)
    pos_score = (queries * gallery[pos_idx]).sum(1).astype(np.float32)
    pos_score[q // 3] = np.nan
    valid = rng.rand(n) > 0.2
    return queries, gallery, pos_idx, pos_score, valid


@pytest.mark.parametrize("q,n", [(64, 256), (50, 300)])
@pytest.mark.parametrize("masked", [False, True])
def test_counts_match_pallas_exactly(q, n, masked):
    queries, gallery, pos_idx, pos_score, valid = _inputs(q, n)
    jargs = dict(gallery_valid=jnp.asarray(valid) if masked else None,
                 pos_idx=jnp.asarray(pos_idx) if masked else None)
    targs = dict(gallery_valid=torch.from_numpy(valid) if masked else None,
                 pos_idx=torch.from_numpy(pos_idx) if masked else None)
    jq, jg, jp = map(jnp.asarray, (queries, gallery, pos_score))
    tq, tg, tp = map(torch.from_numpy, (queries, gallery, pos_score))
    np.testing.assert_array_equal(
        rk.violation_counts(tq, tg, tp, **targs).numpy(),
        np.asarray(pallas_violation_counts(jq, jg, jp, **jargs)))
    ranks = rk.rank_counts(tq, tg, tp, **targs).numpy()
    np.testing.assert_array_equal(
        ranks, np.asarray(pallas_rank_counts(jq, jg, jp, **jargs)))
    assert ranks[q // 3] == (valid.sum() if masked else n)  # NaN -> worst


def test_wrapper_on_cpu_is_the_plain_version_and_refuses_meta():
    queries, gallery, pos_idx, pos_score, valid = map(
        torch.from_numpy, _inputs(20, 70, d=8, seed=1))
    before = cuda_lib.launch_count("rankcount")
    assert torch.equal(
        rk.violation_counts(queries, gallery, pos_score, valid, pos_idx),
        rk.violation_counts_plain(queries, gallery, pos_score, valid,
                                  pos_idx))
    assert cuda_lib.launch_count("rankcount") == before
    with pytest.raises(ValueError):
        rk.violation_counts(queries.to("meta"), gallery.to("meta"),
                            pos_score.to("meta"))
    with pytest.raises(ValueError):
        rk.violation_counts(queries, gallery[:, :-1], pos_score)


def test_should_stream_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not rk.should_stream(10**6, cpu)
    assert rk.should_stream(rk.STREAMING_GALLERY_MIN, cuda)
    assert not rk.should_stream(rk.STREAMING_GALLERY_MIN - 1, cuda)
    assert rk.should_stream(5, cpu, force=True)
    assert not rk.should_stream(10**6, cuda, force=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_ranks_and_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    sims = rng.randn(40, 40).astype(np.float32)
    sims[3, 3] = np.nan
    sims[7] = sims[7, 7]  # an all-tie row: strict counting gives rank 1
    ks = (1, 5, 10)
    want = jax_ranking.bidirectional_metrics(jnp.asarray(sims), ks=ks,
                                             return_ranks=True)
    got = ranking.bidirectional_metrics(torch.from_numpy(sims), ks=ks,
                                        return_ranks=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    valid = rng.rand(40) > 0.3
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    ranks = rng.randint(1, 41, 40).astype(np.int32)
    jr, tr = jnp.asarray(ranks), torch.from_numpy(ranks)
    for jf, tf in ((jax_ranking.masked_median_rank, ranking.masked_median_rank),
                   (jax_ranking.masked_mean_rank, ranking.masked_mean_rank)):
        np.testing.assert_allclose(float(tf(tr, tv)), float(jf(jr, jv)))
    np.testing.assert_allclose(float(ranking.masked_recall_at_k(tr, 5, tv)),
                               float(jax_ranking.masked_recall_at_k(jr, 5, jv)))
    none = torch.zeros(40, dtype=torch.bool)
    assert np.isnan(float(ranking.masked_median_rank(tr, none)))
