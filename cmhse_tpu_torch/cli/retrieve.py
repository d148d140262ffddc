"""``python -m cmhse_tpu_torch.cli.retrieve``, counterpart of
``cmhse-retrieve``: top-k retrieval against a split encoded once on the
card, text->video (``--query``, ``--interactive``) and video->paragraph
(``--query_video``), over :class:`cmhse_tpu_torch.eval.serve.Retriever`
(``--sharded``: the gallery sharded over every local device, in this one
process); or, with ``--connect ADDR``, the same queries sent to a running
``cmhse_tpu_torch.cli.serve_daemon`` (no model, no card)."""

from __future__ import annotations

import argparse
import sys

from cmhse_tpu_torch.cli import add_platform_flag, device_for, sharded_mesh

# no XLA compile to cache
JAX_ONLY_FLAGS = ("--compile_cache",)


def _print_hits(label: str, hits) -> None:
    """``hits``: (key, score) pairs, best first."""
    print(label)
    for rank, (key, score) in enumerate(hits, start=1):
        print(f"  {rank}. {key}  score={float(score):.4f}")


def _connect_main(args, p, argv) -> int:
    """``--connect``: query a running daemon through the port's
    :class:`~cmhse_tpu_torch.client.ServeClient` instead of loading a
    checkpoint; the daemon holds the gallery. Flags that configure the
    gallery are the daemon's, and refused here (``--platform`` only when
    given: its default names the card)."""
    from cmhse_tpu_torch.client import ServeClient, ServeError

    platform_given = any(a == "--platform" or a.startswith("--platform=")
                         for a in (argv if argv is not None else sys.argv))
    daemon_side = [name for name, v in (
        ("--data_path", args.data_path), ("--split", args.split != "val"),
        ("--sharded", args.sharded), ("--quantized", args.quantized),
        ("--rescore_m", args.rescore_m),
        ("--vocab_path", args.vocab_path),
        ("--platform", platform_given)) if v]
    if daemon_side:
        p.error(f"{', '.join(daemon_side)} configure the GALLERY and are "
                "daemon-side; set them on the daemon, not with --connect")
    host, _, port = args.connect.rpartition(":")
    kw = ({"tcp": (host, int(port))} if host and port.isdigit()
          else {"socket_path": args.connect})

    def show(label, hits):
        _print_hits(label, [(h["key"], h["score"]) for h in hits])

    with ServeClient(**kw) as c:
        try:
            if args.query:
                for text, hits in zip(args.query,
                                      c.query(args.query, k=args.k)):
                    show(f"query: {text!r}", hits)
            for key in args.query_video or ():
                show(f"video query: {key!r} (paragraphs)",
                     c.query_video(key, k=args.k))
        except ServeError as e:
            raise SystemExit(f"daemon refused: {e}")
        if args.interactive:
            for line in sys.stdin:
                text = line.strip()
                if not text:
                    continue
                try:
                    show(f"query: {text!r}", c.query(text, k=args.k))
                except ServeError as e:
                    print(f"error: {e}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.retrieve")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="run directory (with config.json); omit with "
                        "--connect")
    p.add_argument("--connect", default=None, metavar="ADDR",
                   help="query a running serve_daemon instead of loading a "
                        "checkpoint: a unix socket path, or HOST:PORT")
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
    p.add_argument("--sharded", action="store_true",
                   help="shard the gallery over every local device in this "
                        "one process (each visible card; CPU shards with "
                        "--platform cpu); not under torchrun")
    p.add_argument("--quantized", action="store_true",
                   help="two-stage int8 top-k for galleries held prepared "
                        "(at least 32,768 rows); exact rescoring of the int8 "
                        "pool (ops/topk.py). No effect on small galleries")
    p.add_argument("--rescore_m", type=int, default=None,
                   help="int8 candidate-pool depth for --quantized (the "
                        "recall dial; default max(64, 4k))")
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
    if args.connect:
        return _connect_main(args, p, argv)
    if args.checkpoint is None:
        p.error("pass a checkpoint dir (or --connect ADDR)")
    device = device_for(args.platform)
    mesh = sharded_mesh(args.platform) if args.sharded else None

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
        _print_hits(label, [(dataset.keys[int(row_ids[int(j)])], s)
                            for j, s in zip(idx, scores)])

    if args.query or args.interactive:
        retriever = Retriever(model, mesh=mesh, quantize=args.quantized,
                              rescore_m=args.rescore_m)
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
        retriever_t = Retriever(model, mesh=mesh, quantize=args.quantized,
                                rescore_m=args.rescore_m)
        retriever_t.build_gallery(side="text", encoded=encoded)
        scores, idx = retriever_t.retrieve_video(*query_video, k=args.k)
        for i, key in enumerate(args.query_video):
            print_hits(f"video query: {key!r} (paragraphs)", scores[i],
                       idx[i])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
