"""Reference-layout dataset fixtures, the port's own copy of
``cmhse_tpu/data/fixtures.py``.

Writes the on-disk layout the reference's data pipeline reads: per split a
``{split}_captions.json`` mapping id -> {timestamps, sentences, duration}
and the features, either in the ActivityNet-challenge ``{split}_features.h5``
with the matrix nested in a group per video (``f[key]['c3d_features']``)
or as ``features/{key}.npy``; plus word2vec ``.bin`` vector files. With the
same seed and arguments the files hold what the JAX package's writes
(pinned by tests/test_torch_fixtures.py). ``h5py`` is imported only for
the h5 layout. :func:`splice_synthetic_gallery` puts a synthetic gallery
of streaming size into a serving daemon's context.
"""

from __future__ import annotations

import json
import os

import numpy as np

# small word pool -> deterministic multi-sentence "captions" with realistic
# punctuation (periods exercise the tokenizer's sentence handling)
_SUBJECTS = ["a man", "a woman", "the dog", "a child", "the chef"]
_VERBS = ["runs", "jumps", "walks", "cooks", "slides"]
_TAILS = ["in the park", "on the street", "near the lake", "at home",
          "down the hill"]


def make_sentence(rng: np.random.RandomState) -> str:
    return (f"{_SUBJECTS[rng.randint(len(_SUBJECTS))]} "
            f"{_VERBS[rng.randint(len(_VERBS))]} "
            f"{_TAILS[rng.randint(len(_TAILS))]}.")


def write_reference_dataset(
    root: str,
    n_train: int = 12,
    n_val: int = 8,
    feat_dim: int = 8,
    seed: int = 0,
    splits: list[tuple[str, int]] | None = None,
    features: str = "h5",
    clips: tuple[int, int] = (1, 4),
    rows: tuple[int, int] = (2, 5),
) -> dict:
    """Write train+val splits (or the given ``splits``) in the reference
    layout; returns metadata ``{"feat_dim", "keys": {split: [key, ...]}}``.

    ``features``: ``"h5"`` or ``"npy"`` (``features/{key}.npy``, which
    ``PrecompDataset`` reads when there is no h5 file). ``clips`` / ``rows``:
    half-open ranges, as ``rng.randint`` takes them, of the clips a video
    and the feature rows a clip; the defaults are the JAX fixture's.
    """
    if features not in ("h5", "npy"):
        raise ValueError(f"features must be 'h5' or 'npy', got {features!r}")
    os.makedirs(root, exist_ok=True)
    if features == "npy":
        os.makedirs(os.path.join(root, "features"), exist_ok=True)
    rng = np.random.RandomState(seed)
    info: dict = {"feat_dim": feat_dim, "keys": {}}
    for split, n in (splits or (("train", n_train), ("val", n_val))):
        captions = {}
        h5 = None
        if features == "h5":
            import h5py

            h5 = h5py.File(os.path.join(root, f"{split}_features.h5"), "w")
        try:
            for i in range(n):
                key = f"v_{split}{i:03d}"
                n_clips = int(rng.randint(*clips))
                rows_per_clip = rng.randint(*rows, size=n_clips)
                total = int(rows_per_clip.sum())
                feats = rng.randn(total, feat_dim).astype(np.float32)
                if h5 is not None:
                    # challenge layout: the matrix nests inside a GROUP
                    h5.create_group(key).create_dataset("c3d_features",
                                                        data=feats)
                else:
                    np.save(os.path.join(root, "features", f"{key}.npy"),
                            feats)
                ts, t0 = [], 0
                for r in rows_per_clip:
                    ts.append([float(t0), float(t0 + int(r))])
                    t0 += int(r)
                captions[key] = {
                    "duration": float(total),  # 1 feature row a "second"
                    "timestamps": ts,
                    "sentences": [make_sentence(rng) for _ in range(n_clips)],
                }
        finally:
            if h5 is not None:
                h5.close()
        with open(os.path.join(root, f"{split}_captions.json"), "w") as f:
            json.dump(captions, f)
        info["keys"][split] = sorted(captions)
    return info


def write_word2vec_bin(path: str, words: list[str], dim: int,
                       seed: int = 7) -> None:
    """Original word2vec C-binary file covering ``words`` (the format
    GoogleNews vectors ship in)."""
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        f.write(f"{len(words)} {dim}\n".encode())
        for w in words:
            f.write(w.encode("utf-8") + b" ")
            f.write(rng.randn(dim).astype("<f4").tobytes())
            f.write(b"\n")


def splice_synthetic_gallery(ctx: dict, n: int, pad: int = 128,
                             seed: int = 0) -> np.ndarray:
    """Replace a serving daemon context's startup gallery with ``n``
    synthetic unit-norm rows (+ ``pad`` invalid tail rows), keyed
    ``v_syn000000...``, laid out as ``build_context`` lays a gallery out
    (slot ``s < n`` is row ``s``, padding only at the tail): the daemon then
    serves a gallery of streaming size without encoding ``n`` videos. The
    same numpy draw, keys and layout as the JAX package's, so both splice
    identical rows from one seed. Returns the rows (padding included)."""
    import torch  # deferred: writing fixtures needs no torch

    r = ctx["retriever"]
    embed = int(r.gallery.shape[1])
    rng = np.random.RandomState(seed)
    v = rng.randn(n + pad, embed).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    ids = np.concatenate([np.arange(n), np.zeros(pad, np.int64)])
    keys = [f"v_syn{i:06d}" for i in range(n)]
    ctx["keys"] = list(keys)
    ctx["key_set"] = set(keys)
    ctx["key_to_row"] = {k: i for i, k in enumerate(keys)}
    rows = torch.from_numpy(v).to(r.gallery.device)
    r.build_gallery(encoded=(rows, rows, torch.from_numpy(valid), ids))
    ctx["retriever_text"] = None
    # the startup text side would resolve its row ids against the spliced
    # key table (well-formed, wrong names): drop it, so a video_key request
    # gets the daemon's "text side unavailable" answer
    ctx["build_text_side"] = None
    ctx["added"].clear()
    ctx["removed_ids"].clear()
    ctx["removed_keys"].clear()
    return v
