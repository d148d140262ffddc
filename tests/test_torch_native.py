"""The port's native batch packer (``cmhse_tpu_torch/native``) against the
port's numpy ``pad_batch`` and against the JAX package's packer
(``cmhse_tpu.native``): every field equal, bf16 frames bit for bit (NaN,
infinities and exact halfway values included); truncation, empty clips and
short batches; concurrent builds; a failed build raises.

The JAX packer is built for this module alone: its loader builds into one
shared ``libpacker.so`` and keeps a failed load for the life of the
process, so pytest workers that build it at once can leave a worker
without it. The fixture points the loader at a library of its own."""

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cmhse_tpu import native as jax_native
from cmhse_tpu.data.bucketing import BucketSpec as JaxBucketSpec
from cmhse_tpu_torch import native
from cmhse_tpu_torch.config import DataConfig
from cmhse_tpu_torch.data import (Batch, BucketSpec,
                                  SyntheticHierarchicalDataset,
                                  batches_from_dataset, pad_batch)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("frames", "frame_len", "clip_len", "words", "word_len", "sent_len",
          "video_ids", "valid")


def _bits(a) -> np.ndarray:
    """Raw bits of a field: bf16 tensors and f32 arrays as integers, so
    NaNs compare by pattern."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int32 if a.dtype == torch.float32
                      else torch.int16).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16).view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _f32(bits: int) -> np.float32:
    return np.frombuffer(np.uint32(bits).tobytes(), np.float32)[0]


# f32 values whose bf16 rounding is the edge: NaNs (quiet, signalling,
# negative, with payload), infinities, signed zeros, denormals, the largest
# finite, and exact halfway values between two bf16s (ties to even, both
# parities)
SPECIAL = np.asarray(
    [np.nan, -np.nan, _f32(0x7F800001), _f32(0xFFA00001), np.inf, -np.inf,
     0.0, -0.0, 1e-40, -1e-40, _f32(0x7F7FFFFF), _f32(0x3F808000),
     _f32(0x3F818000), _f32(0xBF818000), 65535.0, 3.0000002],
    np.float32)


def _examples(case: str):
    feat = 16 if case == "bf16_special" else 6
    ds = SyntheticHierarchicalDataset(num_videos=8, feat_dim=feat,
                                      vocab_size=50, max_clips=6,
                                      max_frames=20, max_words=15, seed=3)
    caps = dict(batch_size=8, max_clips=4, max_frames=10, max_sentences=4,
                max_words=7, feat_dim=feat)
    n, dtype = 8, "float32"
    if case == "f32_short":
        n = 5
    elif case == "truncation":
        caps.update(max_clips=2, max_frames=5, max_sentences=2, max_words=4)
    elif case == "bf16_special":
        dtype = "bfloat16"
    elif case == "bf16_short":
        n, dtype = 3, "bfloat16"
    examples = [ds[i] for i in range(n)]
    if case == "empty_clip":
        examples[0].clips[0] = np.zeros((0, feat), np.float32)
        examples[2].sentences[0] = np.zeros((0,), np.int32)
    if case == "no_clips":
        examples[1].clips.clear()
        examples[6].clips.clear()
        examples[3].sentences.clear()
    if case == "bf16_special":
        examples[0].clips[0][0, :] = SPECIAL
    return examples, caps, dtype


CASES = ["f32_full", "f32_short", "truncation", "empty_clip", "no_clips",
         "bf16_special", "bf16_short"]


@contextlib.contextmanager
def private_jax_packer(lib_dir: Path):
    """The JAX package's packer, built from its own unchanged source into
    ``lib_dir`` and loaded afresh, whatever an earlier load in this process
    left behind; its loader's state is restored on exit. Fails if it does
    not build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(lib_dir / "libpacker.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.available(), "the JAX packer did not build"
        yield jax_native.pack_batch_native


@pytest.fixture(scope="module")
def jax_pack(tmp_path_factory):
    with private_jax_packer(tmp_path_factory.mktemp("jax_packer")) as pack:
        yield pack


@pytest.mark.parametrize("case", CASES)
def test_packer_matches_pad_batch_and_jax_packer(case, jax_pack):
    examples, caps, dtype = _examples(case)
    got = native.pack_batch_native(examples, BucketSpec(**caps,
                                                        feature_dtype=dtype))
    want = pad_batch(examples, BucketSpec(**caps, feature_dtype=dtype))
    jax = jax_pack(examples, JaxBucketSpec(**caps, feature_dtype=dtype))
    if dtype == "bfloat16":
        assert got.frames.dtype == torch.bfloat16
    for f in FIELDS:
        g = _bits(getattr(got, f))
        np.testing.assert_array_equal(g, _bits(getattr(want, f)),
                                      err_msg=f"{f} vs pad_batch")
        np.testing.assert_array_equal(g, _bits(getattr(jax, f)),
                                      err_msg=f"{f} vs the JAX packer")
    if case == "bf16_special":
        # the specials reached the batch: NaNs stay NaN, infinities stay
        row = got.frames[0, 0, 0].float().numpy()
        assert np.isnan(row[:4]).all() and np.isinf(row[4:6]).all()
    if case == "empty_clip":
        assert got.frame_len[0, 0] == 0 and got.word_len[2, 0] == 0


def _dirty_batch(spec: BucketSpec) -> Batch:
    """Outputs for :func:`native.pack_into` that hold no byte of a batch:
    NaN frames (bf16 bits 0xFFFF), every int 0x7EADBEEF, every row valid."""
    shape = (spec.batch_size, spec.max_clips, spec.max_frames, spec.feat_dim)
    if spec.feature_dtype == "bfloat16":
        frames = torch.empty(shape, dtype=torch.bfloat16)
        frames.view(torch.int16).fill_(-1)
    else:
        frames = torch.full(shape, float("nan"))
    b, c, s, w = (spec.batch_size, spec.max_clips, spec.max_sentences,
                  spec.max_words)
    ints = {"frame_len": (b, c), "clip_len": (b,), "words": (b, s, w),
            "word_len": (b, s), "sent_len": (b,), "video_ids": (b,)}
    return Batch(frames=frames, valid=np.ones((b,), bool),
                 **{k: np.full(v, 0x7EADBEEF, np.int32)
                    for k, v in ints.items()})


@pytest.mark.parametrize("case", CASES + ["f32_reused", "bf16_reused"])
def test_padded_packer_matches_pad_batch_on_dirty_buffers(case):
    """The padded entry points (``pack_into``, the pinned path's packer)
    write every byte: into buffers pre-filled with NaN and junk, or reused
    from a longer batch before a shorter one, each field equals
    ``pad_batch``'s bit for bit."""
    if case.endswith("_reused"):
        dtype = case.split("_")[0]
        longer, caps, _ = _examples("bf16_special" if dtype == "bf16"
                                    else "f32_full")
        examples = [dataclasses.replace(ex, clips=ex.clips[:1],
                                        sentences=ex.sentences[:2])
                    for ex in longer[:3]]
        examples[1].clips[0] = examples[1].clips[0][:2]
        dtype = {"bf16": "bfloat16", "f32": "float32"}[dtype]
    else:
        examples, caps, dtype = _examples(case)
    spec = BucketSpec(**caps, feature_dtype=dtype)
    out = _dirty_batch(spec)
    if case.endswith("_reused"):
        first = native.pack_into(longer, spec, out)
        # the longer batch left data where the shorter one pads
        assert first.valid.all() and (first.frame_len[:, 1:] > 0).any()
    got = native.pack_into(examples, spec, out)
    want = pad_batch(examples, spec)
    assert got.frames is out.frames  # packed in place
    assert got.frames.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)), err_msg=f)
    if case == "no_clips":
        assert got.clip_len[1] == got.clip_len[6] == got.sent_len[3] == 0


def test_pack_into_refuses_buffers_it_cannot_fill():
    examples, caps, _ = _examples("f32_short")
    spec = BucketSpec(**caps)
    good = _dirty_batch(spec)
    bad = {"frames": good.frames.to(torch.float64),
           "words": np.zeros((8, 4, 6), np.int32),
           "valid": np.zeros((8,), np.int32),
           "clip_len": np.zeros((8, 2), np.int32)[:, 0]}
    for name, value in bad.items():
        with pytest.raises(ValueError, match=name):
            native.pack_into(examples, spec,
                             dataclasses.replace(good, **{name: value}))
    with pytest.raises(ValueError, match="frames"):
        native.pack_into(examples, spec, dataclasses.replace(
            good, frames=good.frames.numpy()))
    with pytest.raises(ValueError, match="batch of 5"):
        native.pack_into(examples, dataclasses.replace(spec, batch_size=4),
                         _dirty_batch(dataclasses.replace(spec,
                                                          batch_size=4)))


def test_private_jax_packer_loads_after_a_failed_shared_load(tmp_path,
                                                             monkeypatch):
    """A worker whose collection-time load failed (a half-written shared
    library) keeps ``_tried`` set and ``_lib`` None, and the JAX loader
    would refuse for the life of the process; the private build loads all
    the same, packs equal to ``pad_batch``, and leaves the state as it
    found it."""
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert not jax_native.available()
    examples, caps, _ = _examples("f32_short")
    with private_jax_packer(tmp_path) as pack:
        got = pack(examples, JaxBucketSpec(**caps))
    assert (tmp_path / "libpacker.so").is_file()
    want = pad_batch(examples, BucketSpec(**caps))
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)), err_msg=f)
    assert jax_native._tried and jax_native._lib is None


def test_packer_refuses_what_pad_batch_cannot_pack():
    examples, caps, _ = _examples("f32_full")
    with pytest.raises(ValueError, match="batch of 8"):
        native.pack_batch_native(examples, BucketSpec(**{**caps,
                                                         "batch_size": 4}))
    examples[1].clips[0] = np.zeros((3, caps["feat_dim"] + 1), np.float32)
    with pytest.raises(ValueError, match="clip shape"):
        native.pack_batch_native(examples, BucketSpec(**caps))


def test_loader_packs_with_the_native_packer(monkeypatch):
    """batches_from_dataset goes through the packer, and its batches equal
    pad_batch's over the same groups."""
    calls = []
    real = native.pack_batch_native

    def counted(examples, spec, **kw):
        calls.append(len(examples))
        return real(examples, spec, **kw)

    monkeypatch.setattr(native, "pack_batch_native", counted)
    ds = SyntheticHierarchicalDataset(num_videos=11, feat_dim=6,
                                      vocab_size=50, max_clips=4,
                                      max_frames=10, max_words=7, seed=1)
    cfg = DataConfig(batch_size=4, feat_dim=6, vocab_size=50, max_clips=4,
                     max_frames=10, max_sentences=4, max_words=7)
    batches = list(batches_from_dataset(ds, cfg, shuffle=True, seed=2))
    assert calls == [4, 4, 3]
    order = np.random.RandomState(2).permutation(11)
    spec = BucketSpec(4, 4, 10, 4, 7, 6)
    for i, b in enumerate(batches):
        want = pad_batch([ds[int(j)] for j in order[4 * i:4 * i + 4]], spec)
        for f in FIELDS:
            np.testing.assert_array_equal(_bits(getattr(b, f)),
                                          _bits(getattr(want, f)))


BUILD = """
import sys
from pathlib import Path
from cmhse_tpu_torch import native
native.BUILD_ROOT = Path(sys.argv[1])
native.library().pack_tokens
print(native.build())
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (lib,) = paths
    assert Path(lib).is_file() and Path(lib).parent.parent == tmp_path
    # only the library is left: each build's temporary directory is gone
    assert sorted(p.name for p in Path(lib).parent.iterdir()) == [
        "libpacker.so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native packer "
                                           "failed") as err:
        native.build()
    assert "error" in str(err.value)
