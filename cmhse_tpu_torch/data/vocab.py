"""Vocabulary builder, counterpart of ``cmhse_tpu/data/vocab.py`` (the
reference's ``vocab.py``): the same tokenizer ladder, special tokens and id
order, so a vocabulary built by either package gives the same ids.

Tokenization is kept byte-compatible with the reference: NLTK
``word_tokenize`` lowercased, with a frequency threshold, and the same four
special tokens in the same index order (``<pad>``=0, ``<start>``, ``<end>``,
``<unk>``) — retrieval parity is impossible if token ids diverge
(SURVEY.md section 3.4).

Fallback ladder when the Punkt sentence model is not downloadable (offline
images), reported by :func:`tokenizer_backend`:
  1. ``punkt``    — full ``word_tokenize`` (Punkt sentence split + Treebank
     word split); exactly the reference.
  2. ``treebank`` — ``TreebankWordTokenizer`` alone (data-free). For
     SINGLE-SENTENCE captions — which is what both ActivityNet Captions and
     DiDeMo provide (one caption per clip/moment) — this is byte-identical
     to ``word_tokenize``; multi-sentence strings may keep a sentence-final
     period attached mid-string. No production path feeds multi-sentence
     strings anymore: flat mode encodes PER SENTENCE and concatenates ids
     (datasets.py), using the captions json's ground-truth boundaries
     instead of a sentence splitter. tests/test_tokenizer_fixture.py pins
     the exact ids for both cases.
  3. ``regex``    — last resort if nltk itself is missing; token ids DIVERGE
     from the reference. A loud warning is emitted once.
"""

from __future__ import annotations

import json
import pickle
import re
import warnings
from collections import Counter
from typing import Iterable

_FALLBACK_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

# chosen lazily on first tokenize() call: "punkt" | "treebank" | "regex"
_BACKEND: list = [None, None]  # [name, callable]


def _choose_backend():
    try:
        import nltk
    except ImportError:
        warnings.warn(
            "nltk is not installed: falling back to a REGEX tokenizer whose "
            "token ids DIVERGE from the reference vocabulary. Retrieval "
            "parity against reference checkpoints is not possible this way.",
            RuntimeWarning,
            stacklevel=3,
        )
        return "regex", _FALLBACK_RE.findall
    try:
        nltk.tokenize.word_tokenize("probe")
        return "punkt", nltk.tokenize.word_tokenize
    except LookupError:
        # Punkt sentence model not available offline; the Treebank word
        # tokenizer is data-free and byte-identical for single sentences
        return "treebank", nltk.tokenize.TreebankWordTokenizer().tokenize


def tokenizer_backend() -> str:
    """Which tokenizer actually runs: "punkt" | "treebank" | "regex"."""
    if _BACKEND[0] is None:
        _BACKEND[0], _BACKEND[1] = _choose_backend()
    return _BACKEND[0]


def tokenize(caption: str) -> list[str]:
    """Lowercase word tokenization (see the module docstring for the
    backend ladder)."""
    tokenizer_backend()
    return _BACKEND[1](str(caption).lower())


class Vocabulary:
    """word <-> index map with the reference's special-token layout."""

    PAD = "<pad>"
    START = "<start>"
    END = "<end>"
    UNK = "<unk>"

    def __init__(self) -> None:
        self.word2idx: dict[str, int] = {}
        self.idx2word: dict[int, str] = {}
        self.idx = 0
        for tok in (self.PAD, self.START, self.END, self.UNK):
            self.add_word(tok)

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[self.UNK])

    def __len__(self) -> int:
        return len(self.word2idx)

    # -- encoding ---------------------------------------------------------

    def encode(self, caption: str, add_bos_eos: bool = True) -> list[int]:
        """Caption string -> token ids, reference-style: <start> w... <end>."""
        ids = [self(w) for w in tokenize(caption)]
        if add_bos_eos:
            return [self(self.START)] + ids + [self(self.END)]
        return ids

    # -- serialization (pickle like the reference, plus JSON) --------------

    def save(self, path: str) -> None:
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.word2idx, f)
        else:
            with open(path, "wb") as f:
                pickle.dump(self, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        if path.endswith(".json"):
            with open(path) as f:
                w2i = json.load(f)
            vocab = cls.__new__(cls)
            vocab.word2idx = w2i
            vocab.idx2word = {int(i): w for w, i in w2i.items()}
            vocab.idx = len(w2i)
            return vocab
        with open(path, "rb") as f:
            obj = _TolerantUnpickler(f).load()
        if isinstance(obj, cls):
            return obj
        # reference-era pickled Vocabulary (same attrs, alien class)
        vocab = cls.__new__(cls)
        vocab.word2idx = dict(obj.word2idx)
        vocab.idx2word = {int(i): w for i, w in obj.idx2word.items()}
        vocab.idx = len(vocab.word2idx)
        return vocab


class _TolerantUnpickler(pickle.Unpickler):
    """Resolve any pickled ``*.Vocabulary`` class to ours, so vocab pickles
    written by the reference's ``vocab.py`` module (not importable here)
    still load."""

    def find_class(self, module, name):
        if name == "Vocabulary":
            return Vocabulary
        return super().find_class(module, name)


def build_vocab(
    captions: Iterable[str], threshold: int = 4
) -> Vocabulary:
    """Frequency-thresholded vocabulary from an iterable of caption strings
    (reference ``build_vocab``: count -> filter by threshold -> add).

    Word ids are assigned in corpus FIRST-OCCURRENCE order — what the
    reference's ``[w for w, c in counter.items() if c >= threshold]``
    produces on any modern Python (Counter preserves insertion order), so
    a rebuild over the same captions is id-compatible with a
    reference-built vocabulary. (Under the 2018-era Python 2 the reference
    shipped on, dict order was arbitrary — TRUE id parity with a historic
    run needs the reference's own pickle, which :meth:`Vocabulary.load`
    reads directly.) An earlier revision sorted alphabetically, which was
    deterministic but id-INCOMPATIBLE with a modern reference rebuild.

    Prints the tokenizer backend in use so a vocabulary accidentally built
    with the non-parity regex fallback is visible in the build log."""
    backend = tokenizer_backend()
    print(f"build_vocab: tokenizer backend = {backend}"
          + (" (WARNING: token ids diverge from the reference!)"
             if backend == "regex" else ""))
    counter: Counter[str] = Counter()
    for cap in captions:
        counter.update(tokenize(cap))
    words = [w for w, c in counter.items() if c >= threshold]
    vocab = Vocabulary()
    for w in words:
        vocab.add_word(w)
    return vocab


def find_vocab(data_path: str, explicit: str | None = None) -> str:
    """Resolve the vocabulary file of a data directory, as the JAX
    package's ``find_vocab`` does: an explicit path wins; then the first of
    ``vocab.json`` / ``vocab.pkl`` / ``vocab.pickle`` present; then the
    first ``*vocab*.pkl`` (reference users arrive with pickled vocabularies,
    such as ``anet_precomp_vocab.pkl``)."""
    import glob
    import os

    if explicit:
        return explicit
    for name in ("vocab.json", "vocab.pkl", "vocab.pickle"):
        p = os.path.join(data_path, name)
        if os.path.exists(p):
            return p
    hits = sorted(glob.glob(os.path.join(data_path, "*vocab*.pkl")))
    if hits:
        return hits[0]
    raise FileNotFoundError(
        f"no vocabulary file found under {data_path} (looked for "
        "vocab.json / vocab.pkl / *vocab*.pkl); build one with python -m "
        "cmhse_tpu_torch.cli.build_vocab (cmhse-vocab in the JAX package) "
        "or pass --vocab_path"
    )
