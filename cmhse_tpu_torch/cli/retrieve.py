"""``python -m cmhse_tpu_torch.cli.retrieve``, counterpart of
``cmhse-retrieve``: top-k retrieval against a split encoded once on the
card, text->video (``--query``, ``--interactive``) and video->paragraph
(``--query_video``), over :class:`cmhse_tpu_torch.eval.serve.Retriever`."""

from __future__ import annotations

import argparse
import sys

from cmhse_tpu_torch.cli import add_platform_flag, device_for

# no XLA compile to cache
JAX_ONLY_FLAGS = ("--compile_cache",)
# flags of the JAX command that wait for a later slice (ROADMAP A)
LATER_FLAGS = {
    "--quantized": "A.5 serving (int8 two-stage top-k)",
    "--rescore_m": "A.5 serving (int8 two-stage top-k)",
    "--connect": "A.6 daemon",
    "--sharded": "A.7 multi-GPU",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.retrieve")
    p.add_argument("checkpoint", help="run directory (with config.json)")
    p.add_argument("--data_path", default=None)
    p.add_argument("--split", default="val", help="gallery split")
    p.add_argument("--query", action="append", default=None,
                   help="natural-language query, text->video (repeatable)")
    p.add_argument("--query_video", action="append", default=None,
                   help="dataset video key as the query, video->paragraph "
                        "(repeatable)")
    p.add_argument("--interactive", action="store_true",
                   help="after any --query, read further text queries from "
                        "stdin (one a line) against the same gallery")
    p.add_argument("-k", type=int, default=5)
    p.add_argument("--vocab_path", default=None,
                   help="default: vocab.json/vocab.pkl under the data dir")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if not args.query and not args.query_video and not args.interactive:
        p.error("pass --query (text->video), --query_video "
                "(video->paragraph), or --interactive")
    device = device_for(args.platform)

    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset, find_vocab)
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.serve import (Retriever, text_query_batch,
                                            video_query_batch)
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    model, cfg = restore_for_eval(args.checkpoint, device=device)
    data_path = args.data_path or cfg.data.data_path
    vocab = Vocabulary.load(find_vocab(data_path, args.vocab_path))
    dataset = PrecompDataset(data_path, args.split, vocab,
                             feat_dim=cfg.data.feat_dim,
                             flat=not cfg.model.hierarchical)
    if args.query_video:
        # before the encode: an unknown key is the caller's typo
        try:
            query_video = video_query_batch(dataset, cfg.data,
                                            args.query_video)
        except KeyError as e:
            raise SystemExit(
                f"video keys not in the {args.split} split: {e.args[0]}")

    # one encode feeds both directions' galleries; the ids map gallery rows
    # back to dataset keys
    encoded = encode_gallery_device(
        model, batches_from_dataset(dataset, cfg.data, shuffle=False),
        return_ids=True)
    row_ids = encoded[3]

    def print_hits(label, scores, idx):
        print(label)
        for rank, (j, s) in enumerate(zip(idx, scores), start=1):
            print(f"  {rank}. {dataset.keys[int(row_ids[int(j)])]}  "
                  f"score={float(s):.4f}")

    if args.query or args.interactive:
        retriever = Retriever(model)
        retriever.build_gallery(side="video", encoded=encoded)
        smax, wmax = cfg.data.max_sentences, cfg.data.max_words
        if args.query:
            scores, idx = retriever.retrieve(
                *text_query_batch(vocab, args.query, smax, wmax), k=args.k)
            for i, text in enumerate(args.query):
                print_hits(f"query: {text!r}", scores[i], idx[i])
        if args.interactive:
            # encode once, serve many: one query a stdin line
            for line in sys.stdin:
                text = line.strip()
                if not text:
                    continue
                scores, idx = retriever.retrieve(
                    *text_query_batch(vocab, [text], smax, wmax), k=args.k)
                print_hits(f"query: {text!r}", scores[0], idx[0])

    if args.query_video:
        retriever_t = Retriever(model)
        retriever_t.build_gallery(side="text", encoded=encoded)
        scores, idx = retriever_t.retrieve_video(*query_video, k=args.k)
        for i, key in enumerate(args.query_video):
            print_hits(f"video query: {key!r} (paragraphs)", scores[i],
                       idx[i])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
