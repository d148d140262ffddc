"""The port's serving top-k against the JAX package's: ``streaming_sim_topk``
and the dense path return the same indices as JAX's ``streaming_sim_topk``
and ``_dense_topk`` — tie order included (equal scores resolve to the lowest
gallery index) — with a gallery that holds duplicated rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmhse_tpu.eval.serve import _dense_topk as jax_dense_topk
from cmhse_tpu.ops.topk import prepare_topk_gallery as jax_prepare
from cmhse_tpu.ops.topk import streaming_sim_topk as jax_streaming
from cmhse_tpu_torch.ops.topk import (DENSE_TOPK_MAX_BYTES, PreparedGallery,
                                      dense_sim_topk, prepare_topk_gallery,
                                      should_stream_topk, streaming_sim_topk,
                                      topk_lowest_index)

torch.set_num_threads(2)


def _gallery(n, d, seed, exact):
    rng = np.random.RandomState(seed)
    g = rng.randn(n, d)
    q = rng.randn(6, d)
    if exact:  # multiples of 1/8: every score exact, many genuine ties
        g, q = np.round(g * 8) / 8, np.round(q * 8) / 8
    g = g.astype(np.float32)
    g[n - 3] = g[2]          # duplicates in different chunks
    g[n // 2 + 1] = g[n // 2]  # adjacent duplicates
    valid = np.ones(n, bool)
    valid[[1, n // 3]] = False
    return q.astype(np.float32), g, valid


@pytest.mark.parametrize("n,chunk,k", [
    (100, 32, 5),      # ragged final chunk
    (64, 64, 10),      # single chunk
    (96, 32, 33),      # k > chunk
    (7, 32, 3),        # gallery smaller than the chunk
    (256, 32, 1),      # k = 1
    (300, None, 40),   # adaptive chunking
])
@pytest.mark.parametrize("exact", [False, True])
def test_indices_equal_jax_ties_included(n, chunk, k, exact):
    q, g, valid = _gallery(n, 8, seed=n + k, exact=exact)
    js, ji = jax_streaming(jnp.asarray(q), jnp.asarray(g), k,
                           valid=jnp.asarray(valid), chunk=chunk)
    ts, ti = streaming_sim_topk(torch.from_numpy(q), torch.from_numpy(g), k,
                                valid=torch.from_numpy(valid), chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    ds, di = jax_dense_topk(jnp.asarray(q), jnp.asarray(g),
                            jnp.asarray(valid), k)
    ps, pi = dense_sim_topk(torch.from_numpy(q), torch.from_numpy(g),
                            torch.from_numpy(valid), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(di))
    np.testing.assert_allclose(ps.numpy(), np.asarray(ds), rtol=1e-5,
                               atol=1e-5)


def test_all_equal_scores_resolve_to_lowest_index():
    scores = torch.zeros(2, 9)
    scores[1, 4] = float("-inf")
    s, i = topk_lowest_index(scores, 9)
    assert i[0].tolist() == list(range(9))
    assert i[1].tolist() == [0, 1, 2, 3, 5, 6, 7, 8, 4]
    neg = torch.tensor([[-0.5, -2.0, 3.0, -0.5, float("-inf"), 0.0]])
    _, i = topk_lowest_index(neg, 6)
    assert i[0].tolist() == [2, 5, 0, 3, 1, 4]


def test_prepared_gallery_matches_jax_chunking_and_results():
    q, g, valid = _gallery(1000, 8, seed=3, exact=False)
    jp = jax_prepare(jnp.asarray(g), jnp.asarray(valid), convert=False)
    tp = prepare_topk_gallery(torch.from_numpy(g), torch.from_numpy(valid))
    assert isinstance(tp, PreparedGallery)
    assert tuple(tp.chunks.shape) == tuple(jp.chunks.shape)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    _, ji = jax_streaming(jnp.asarray(q), jp, 12)
    _, ti = streaming_sim_topk(torch.from_numpy(q), tp, 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        streaming_sim_topk(torch.from_numpy(q), tp, 12,
                           valid=torch.from_numpy(valid))


def test_should_stream_topk_threshold():
    rows = DENSE_TOPK_MAX_BYTES // 4  # f32 scores the budget holds
    assert not should_stream_topk(1, rows)
    assert should_stream_topk(1, rows + 1)
    assert not should_stream_topk(8, rows // 8)
    assert not should_stream_topk(1024, 100_000)  # 410 MB block: dense
    assert should_stream_topk(1024, 1_000_000)    # 4.1 GB block: streaming


# --- the int8 two-stage path, append, the grouped pre-select ---------------

from cmhse_tpu.ops.topk import _grouped_preselect as jax_grouped  # noqa: E402
from cmhse_tpu.ops.topk import _quantize_rows_int8 as jax_quantize  # noqa: E402
from cmhse_tpu.ops.topk import append_to_prepared as jax_append  # noqa: E402
from cmhse_tpu.ops.topk import quantized_sim_topk as jax_quantized  # noqa: E402
from cmhse_tpu_torch.ops.topk import (  # noqa: E402
    _GROUP, _grouped_preselect, _quantize_rows_int8, append_to_prepared,
    int8_product, quantized_sim_topk)


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _equal_forms(tp, jp):
    for name in ("chunks", "valid", "int8_chunks", "int8_scale"):
        want, got = getattr(jp, name), getattr(tp, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert tuple(got.shape) == tuple(want.shape), name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)


def test_quantize_rows_int8_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    x[5] = 0.0                                   # all-zero row: scale 1
    x[6] = np.arange(32, dtype=np.float32) - 15.5  # 16 * k + 0.5 / 127 steps
    x[7, :4] = [127.0, 63.5, -0.5, 0.5]          # half-way points of the grid
    x[8, :3] = [2.0, 1.0 / 127 * 2 * 0.5, -2.0]  # exact halves at scale 2/127
    q, s = _quantize_rows_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[5] == 1.0 and not q[5].any()


@pytest.mark.parametrize("n,chunk", [(1000, None), (300, 100), (0, None)])
def test_prepare_quantized_matches_jax(n, chunk):
    rng = np.random.RandomState(n + 1)
    g = _unit_rows(rng, n, 16)
    valid = rng.rand(n) > 0.2
    tp = prepare_topk_gallery(torch.from_numpy(g), torch.from_numpy(valid),
                              chunk=chunk, quantize=True)
    jp = jax_prepare(jnp.asarray(g), jnp.asarray(valid), chunk=chunk,
                     convert=False, quantize=True)
    _equal_forms(tp, jp)


def test_append_to_prepared_equals_fresh_prepare_and_jax():
    rng = np.random.RandomState(4)
    parts = [_unit_rows(rng, n, 16) for n in (300, 5, 130, 1, 400)]
    valids = [rng.rand(len(p)) > 0.1 for p in parts]
    tp = prepare_topk_gallery(torch.from_numpy(parts[0]),
                              torch.from_numpy(valids[0]), quantize=True)
    jp = jax_prepare(jnp.asarray(parts[0]), jnp.asarray(valids[0]),
                     convert=False, quantize=True)
    n = len(parts[0])
    for p, v in zip(parts[1:], valids[1:]):
        tp = append_to_prepared(tp, torch.from_numpy(p), n,
                                valid=torch.from_numpy(v))
        jp = jax_append(jp, jnp.asarray(p), n, valid=jnp.asarray(v),
                        convert=False)
        n += len(p)
        _equal_forms(tp, jp)
    # a fresh prepare of the concatenation at the same chunk size
    csize = tp.chunks.shape[1]
    fresh = prepare_topk_gallery(torch.from_numpy(np.concatenate(parts)),
                                 torch.from_numpy(np.concatenate(valids)),
                                 chunk=csize, quantize=True)
    assert fresh.chunks.shape[1] == csize
    rows = n
    for name in ("chunks", "valid", "int8_chunks", "int8_scale"):
        a = getattr(tp, name).reshape(-1, *getattr(tp, name).shape[2:])
        b = getattr(fresh, name).reshape(-1, *getattr(fresh, name).shape[2:])
        assert torch.equal(a[:rows], b[:rows]), name
    # the tail slots are padding: invalid in both (a prepare quantizes its
    # zero rows to scale 1, an append pads the scales with 0, as in JAX)
    assert not tp.valid.reshape(-1)[rows:].any()
    assert not fresh.valid.reshape(-1)[rows:].any()
    q = torch.from_numpy(_unit_rows(rng, 5, 16))
    assert torch.equal(streaming_sim_topk(q, tp, 9)[1],
                       streaming_sim_topk(q, fresh, 9)[1])
    with pytest.raises(ValueError):
        append_to_prepared(tp, torch.zeros(2, 8), n)
    with pytest.raises(ValueError):
        append_to_prepared(tp, torch.zeros(2, 16), 10**6)
    assert append_to_prepared(tp, torch.zeros(0, 16), n) is tp


def test_append_unifies_storage_dtype():
    g = torch.from_numpy(_unit_rows(np.random.RandomState(5), 200, 16))
    tp = prepare_topk_gallery(g.bfloat16())
    out = append_to_prepared(tp, g[:7], 200)
    assert out.chunks.dtype == torch.bfloat16


@pytest.mark.parametrize("exact", [False, True])
def test_grouped_preselect_equals_plain_topk_and_jax(exact):
    rng = np.random.RandomState(6)
    ngroups, kk = 12, 5
    s = rng.randn(7, ngroups * _GROUP).astype(np.float32)
    if exact:  # coarse values: ties everywhere, inside and across groups
        s = np.round(s * 2) / 2
    s[0, :] = 1.0                     # one row all tied
    s[1, 3 * _GROUP:4 * _GROUP] = -np.inf  # a masked group
    s[2, [5, 900, 1400]] = 9.0        # planted ties in three groups
    sims = torch.from_numpy(s)
    gs, gi = _grouped_preselect(sims.reshape(7, ngroups, _GROUP), kk)
    ps, pi = topk_lowest_index(sims, kk)
    assert torch.equal(gi, pi) and torch.equal(gs, ps)
    assert gi[0].tolist() == list(range(kk))
    assert gi[2, :3].tolist() == [5, 900, 1400]
    js, ji = jax_grouped(jnp.asarray(s).reshape(7, ngroups, _GROUP), kk)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(js))


def _grouped_body(prep, kk):
    """Whether a chunk's local top-kk takes the grouped pre-select."""
    csize = prep.chunks.shape[1]
    return csize % _GROUP == 0 and csize // _GROUP >= 2 * kk


@pytest.mark.parametrize("n,chunk,k,rescore_m,grouped", [
    (20000, None, 10, None, True),  # adaptive: 4 chunks of 40 groups
    (6000, 3000, 5, 16, True),      # rescore_m above k
    (3000, 3000, 10, 10, True),     # rescore_m = k, one chunk
    (1000, 128, 10, None, False),   # forced small chunk: plain body
    (3000, None, 10, None, False),  # 6 groups a chunk < 2 kk: plain body
    (200, 64, 5, 300, False),       # rescore_m above capacity: clamped
    (120, None, 100, None, False),  # k up to the valid rows of one chunk
])
@pytest.mark.parametrize("exact", [False, True])
def test_quantized_sim_topk_matches_jax(n, chunk, k, rescore_m, grouped,
                                        exact):
    rng = np.random.RandomState(n + k)
    g = _unit_rows(rng, n, 16)
    q = _unit_rows(rng, 9, 16)
    if exact:  # multiples of 1/8: exact scores, genuine ties
        g, q = np.round(g * 8) / 8, np.round(q * 8) / 8
    g[n // 2] = g[3]          # duplicates in different chunks
    q[0] = g[3]
    valid = np.ones(n, bool)
    valid[[1, n // 3]] = False
    k = min(k, int(valid.sum()))
    tp = prepare_topk_gallery(torch.from_numpy(g), torch.from_numpy(valid),
                              chunk=chunk, quantize=True)
    jp = jax_prepare(jnp.asarray(g), jnp.asarray(valid), chunk=chunk,
                     convert=False, quantize=True)
    n_chunks, csize = tp.valid.shape
    m = min(max(64, 4 * k) if rescore_m is None else rescore_m,
            n_chunks * csize)
    assert _grouped_body(tp, min(max(k, -(-m // n_chunks)), csize)) == grouped
    ts, ti = quantized_sim_topk(torch.from_numpy(q), tp, k,
                                rescore_m=rescore_m)
    js, ji = jax_quantized(jnp.asarray(q), jp, k, rescore_m=rescore_m)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    assert ti[0, :2].tolist() == [3, n // 2]  # the tie, lowest index first


@pytest.mark.parametrize("exact", [False, True])
def test_streaming_grouped_body_matches_jax(exact):
    """The exact scan's grouped body (2 chunks of 24 groups, kk = 5)."""
    q, g, valid = _gallery(6000, 8, seed=21, exact=exact)
    tp = prepare_topk_gallery(torch.from_numpy(g), torch.from_numpy(valid),
                              chunk=3000)
    assert _grouped_body(tp, 5)
    js, ji = jax_streaming(jnp.asarray(q), jnp.asarray(g), 5,
                           valid=jnp.asarray(valid), chunk=3000)
    ts, ti = streaming_sim_topk(torch.from_numpy(q), tp, 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    _, di = dense_sim_topk(torch.from_numpy(q), torch.from_numpy(g),
                           torch.from_numpy(valid), 5)
    assert torch.equal(ti, di)


def test_quantized_k_equal_to_capacity():
    rng = np.random.RandomState(11)
    g = _unit_rows(rng, 256, 16)
    q = _unit_rows(rng, 3, 16)
    tp = prepare_topk_gallery(torch.from_numpy(g), quantize=True)
    jp = jax_prepare(jnp.asarray(g), convert=False, quantize=True)
    cap = tp.chunks.shape[0] * tp.chunks.shape[1]
    ts, ti = quantized_sim_topk(torch.from_numpy(q), tp, cap)
    js, ji = jax_quantized(jnp.asarray(q), jp, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)


def test_quantized_errors_are_jax_errors():
    g = torch.from_numpy(_unit_rows(np.random.RandomState(12), 300, 16))
    q = g[:2]
    plain = prepare_topk_gallery(g)
    with pytest.raises(ValueError, match="quantize=True"):
        quantized_sim_topk(q, plain, 5)
    with pytest.raises(ValueError, match="quantize=True"):
        jax_quantized(jnp.asarray(q.numpy()),
                      jax_prepare(jnp.asarray(g.numpy()), convert=False), 5)
    prep = prepare_topk_gallery(g, quantize=True)
    jprep = jax_prepare(jnp.asarray(g.numpy()), convert=False, quantize=True)
    with pytest.raises(ValueError, match="rescore_m=4 must be >= k=5"):
        quantized_sim_topk(q, prep, 5, rescore_m=4)
    with pytest.raises(ValueError, match="rescore_m=4 must be >= k=5"):
        jax_quantized(jnp.asarray(q.numpy()), jprep, 5, rescore_m=4)
    with pytest.raises(ValueError, match="capacity"):
        quantized_sim_topk(q, prep, 10**6)


def test_int8_product_exact():
    rng = np.random.RandomState(13)
    a = torch.from_numpy(rng.randint(-127, 128, (3, 20)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (11, 20)).astype(np.int8))
    got = int8_product(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, a.int() @ b.int().T)
