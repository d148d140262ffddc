"""``python -m cmhse_tpu_torch.cli.build_vocab``, counterpart of
``cmhse-vocab`` (the reference's ``python vocab.py``): tokenize a split's
captions, threshold by frequency, write the vocabulary (``.json`` or
``.pkl``). The work is the host's; like every entry point of the port it
takes ``--platform`` and refuses to start without a card unless it is
``cpu``, so one chain of commands runs with one flag."""

from __future__ import annotations

import argparse
import json
import os

from cmhse_tpu_torch.cli import add_platform_flag, device_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.build_vocab")
    p.add_argument("--data_path", required=True)
    p.add_argument("--data_name", default=None,
                   help="optional dataset subdirectory under --data_path "
                        "(the reference's layout: "
                        "<data_path>/<data_name>/{split}_captions.json); "
                        "omit when --data_path is the dataset directory")
    p.add_argument("--split", default="train")
    p.add_argument("--threshold", type=int, default=4)
    p.add_argument("--out", default=None,
                   help="output path (.json or .pkl); default "
                        "<data_path>/vocab.json")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_for(args.platform)

    from cmhse_tpu_torch.data.vocab import build_vocab

    root = (os.path.join(args.data_path, args.data_name)
            if args.data_name else args.data_path)
    cap_path = os.path.join(root, f"{args.split}_captions.json")
    if args.data_name and not os.path.exists(cap_path):
        raise SystemExit(
            f"no {args.split}_captions.json under {root}; --data_name "
            "selects a dataset SUBDIRECTORY of --data_path — omit it if "
            "--data_path already points at the dataset directory")
    with open(cap_path) as f:
        captions_meta = json.load(f)
    captions = [s for meta in captions_meta.values()
                for s in meta["sentences"]]
    vocab = build_vocab(captions, threshold=args.threshold)
    out = args.out or os.path.join(root, "vocab.json")
    vocab.save(out)
    print(f"vocabulary: {len(vocab)} words -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
