"""Pretrained word-vector initialization, counterpart of
``cmhse_tpu/data/word_vectors.py`` (the reference initializes its
``nn.Embedding`` from word2vec vectors).

Loads a word2vec-style text file (``word v1 v2 ...`` per line, with an
optional ``count dim`` header), the original C-tool ``.bin`` binary format
(GoogleNews-vectors ships this way), or an ``.npz`` with ``words`` and
``vectors`` arrays, and produces an embedding table aligned to a
:class:`Vocabulary`. Out-of-vocabulary rows keep their random init (the
reference's behavior).
"""

from __future__ import annotations

import numpy as np

import torch

from cmhse_tpu_torch.data.vocab import Vocabulary


def load_word_vectors(path: str) -> dict[str, np.ndarray]:
    """Parse a vectors file into {word: vector}."""
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        words = [w if isinstance(w, str) else w.decode() for w in data["words"]]
        return dict(zip(words, np.asarray(data["vectors"], np.float32)))
    if path.endswith(".bin"):
        return _load_word2vec_binary(path)
    vecs: dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        # whitespace-split (not single-space): the original word2vec C tool
        # prints a trailing space per line, which would otherwise put an
        # empty string into the float conversion
        first = f.readline().split()
        if len(first) == 2 and first[0].isdigit() and first[1].isdigit():
            pass  # header line: "count dim"
        elif first:
            vecs[first[0]] = np.asarray(first[1:], np.float32)
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            vecs[parts[0]] = np.asarray(parts[1:], np.float32)
    return vecs


def _load_word2vec_binary(path: str) -> dict[str, np.ndarray]:
    """The original word2vec C-tool binary format (how the 2018-era recipe's
    GoogleNews vectors ship): an ASCII header line
    ``"<count> <dim>\\n"``, then per record the word bytes terminated by a
    single space, followed by ``dim`` raw little-endian float32s. The C tool
    writes a ``\\n`` after each vector; some writers omit it, so leading
    newlines are skipped when scanning the next word.

    Parsed over ``mmap`` (GoogleNews is 3M records / 3.4 GB: a
    byte-at-a-time ``f.read(1)`` scanner costs tens of millions of Python
    file reads and minutes of startup on one core; ``mm.find`` +
    ``np.frombuffer`` views do the same work at C speed, and the page cache
    — not Python — decides what stays resident)."""
    import mmap

    vecs: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            nl = mm.find(b"\n")
            header = mm[: nl if nl >= 0 else 0].split()
            if nl < 0 or len(header) != 2:
                raise ValueError(
                    f"{path}: malformed word2vec binary header {header!r} "
                    "(expected b'<count> <dim>')"
                )
            count, dim = int(header[0]), int(header[1])
            vec_bytes = 4 * dim
            pos, end = nl + 1, len(mm)
            for _ in range(count):
                # skip the record separator(s) the C tool writes after each
                # vector; some writers omit them
                while pos < end and mm[pos] == 0x0A:
                    pos += 1
                sp = mm.find(b" ", pos)
                if sp < 0 or sp + 1 + vec_bytes > end:
                    raise ValueError(
                        f"{path}: truncated after {len(vecs)} of {count} "
                        "records"
                    )
                word = mm[pos:sp].decode("utf-8", "replace")
                # copy out of the map (the dict outlives the mmap)
                vecs[word] = np.frombuffer(
                    mm, dtype="<f4", count=dim, offset=sp + 1
                ).astype(np.float32, copy=True)
                pos = sp + 1 + vec_bytes
        finally:
            mm.close()
    return vecs


def init_embedding_table(
    vocab: Vocabulary,
    vectors: dict[str, np.ndarray],
    word_dim: int,
    base_table: np.ndarray | None = None,
    seed: int = 0,
) -> tuple[np.ndarray, int]:
    """Build a ``[len(vocab), word_dim]`` table: pretrained rows where the
    vocab word has a vector, (existing or fresh uniform) random rows
    otherwise. Returns (table, n_hit)."""
    n = len(vocab)
    if base_table is not None:
        table = np.array(base_table, np.float32, copy=True)
        # the model's table may be PADDED beyond the vocab (static vocab_size
        # rounded up is TPU-friendly); it must never be smaller
        if table.shape[0] < n or table.shape[1] != word_dim:
            raise ValueError(
                f"base table {table.shape} too small for vocab "
                f"({n} words, dim {word_dim})"
            )
    else:
        rng = np.random.RandomState(seed)
        table = rng.uniform(-0.1, 0.1, size=(n, word_dim)).astype(np.float32)
    hits = 0
    dim_mismatches = 0
    for word, idx in vocab.word2idx.items():
        vec = vectors.get(word)
        if vec is None:
            continue
        if vec.shape[0] != word_dim:
            dim_mismatches += 1
            continue
        table[idx] = vec
        hits += 1
    if hits == 0 and dim_mismatches > 0:
        # a wrong-dimension vectors file matches ZERO rows: silently
        # training on random embeddings instead of the requested pretrained
        # init would be very hard to notice (hits=0 buried in log.jsonl)
        any_dim = next(iter(vectors.values())).shape[0] if vectors else "?"
        raise ValueError(
            f"word2vec init matched 0 vocabulary words: the vectors are "
            f"{any_dim}-dimensional but word_dim={word_dim} — wrong file or "
            "wrong --word_dim"
        )
    table[vocab.word2idx[Vocabulary.PAD]] = 0.0
    return table, hits


def apply_pretrained_embeddings(model, vocab: Vocabulary,
                                vectors_path: str) -> int:
    """Overwrite the rows of ``model.word_embedding.embedding`` that have a
    pretrained vector, in place on the model's device; returns the number
    of rows loaded."""
    param = model.word_embedding.embedding
    table = param.detach().cpu().numpy()
    vecs = load_word_vectors(vectors_path)
    new_table, hits = init_embedding_table(
        vocab, vecs, word_dim=table.shape[1], base_table=table
    )
    with torch.no_grad():
        param.copy_(torch.from_numpy(new_table))
    return hits
