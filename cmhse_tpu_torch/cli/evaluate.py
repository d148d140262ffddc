"""``python -m cmhse_tpu_torch.cli.evaluate``, counterpart of ``cmhse-eval``
(the reference's ``python evaluation.py``): restore a run directory,
encode a split, print the R@k table, optionally dump per-query ranks."""

from __future__ import annotations

import argparse

from cmhse_tpu_torch.cli import add_platform_flag, device_for

# no XLA compile to cache
JAX_ONLY_FLAGS = ("--compile_cache",)
# flags of the JAX command that wait for a later slice (ROADMAP A)
LATER_FLAGS = {
    "--sharded": "A.7 multi-GPU",
    "--mode": "A.7 multi-GPU",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.evaluate")
    p.add_argument("checkpoint", help="run directory (with config.json)")
    p.add_argument("--data_path", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--ks", default="1,5,10,50")
    p.add_argument("--streaming", action="store_true", default=None,
                   help="force the streaming rank-count kernel (no [Q, N] "
                        "similarity block); default: by gallery size")
    p.add_argument("--no_streaming", dest="streaming", action="store_false")
    p.add_argument("--profile_dir", default=None,
                   help="record the evaluation with torch.profiler and "
                        "write a Chrome trace into this dir")
    p.add_argument("--dump_ranks", default=None, metavar="PATH",
                   help="write per-query JSONL (index/key/v2p_rank/p2v_rank)"
                        "; the JAX package's format")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)

    from cmhse_tpu_torch.eval.retrieval import evalrank
    from cmhse_tpu_torch.utils.timing import profiler_trace

    ks = tuple(int(k) for k in args.ks.split(","))
    with profiler_trace(args.profile_dir):
        evalrank(args.checkpoint, data_path=args.data_path, split=args.split,
                 ks=ks, streaming=args.streaming,
                 dump_ranks=args.dump_ranks, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
