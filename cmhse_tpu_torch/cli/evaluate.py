"""``python -m cmhse_tpu_torch.cli.evaluate``, counterpart of ``cmhse-eval``
(the reference's ``python evaluation.py``): restore a run directory,
encode a split, print the R@k table, optionally dump per-query ranks.

``--sharded`` ranks over a mesh of every rank of the run; several cards
take ``torchrun --nproc_per_node=N -m cmhse_tpu_torch.cli.evaluate RUN
--sharded [--mode gallery]``."""

from __future__ import annotations

import argparse

from cmhse_tpu_torch.cli import add_platform_flag, device_for

# no XLA compile to cache
JAX_ONLY_FLAGS = ("--compile_cache",)


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
    p.add_argument("--sharded", action="store_true",
                   help="rank over a mesh of every rank of the run (one "
                        "card a rank under torchrun)")
    p.add_argument("--mode", default="query", choices=["query", "gallery"],
                   help="how the sharded count splits its work: the "
                        "queries or the gallery over the ranks")
    p.add_argument("--profile_dir", default=None,
                   help="record the evaluation with torch.profiler and "
                        "write a Chrome trace (trace.json) into this dir, "
                        "with the port's spans and counters beside it "
                        "(spans.json, on the trace's own timebase)")
    p.add_argument("--dump_ranks", default=None, metavar="PATH",
                   help="write per-query JSONL (index/key/v2p_rank/p2v_rank)"
                        "; the JAX package's format")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)

    from cmhse_tpu_torch.eval.retrieval import evalrank
    from cmhse_tpu_torch.parallel.mesh import (make_mesh,
                                               maybe_initialize_distributed,
                                               process_count)
    from cmhse_tpu_torch.utils.timing import profiler_trace

    # under torchrun: the process group from its environment, as the JAX
    # command initializes jax.distributed
    maybe_initialize_distributed(device)
    mesh = None
    if args.sharded:
        mesh = make_mesh((-1,), ("data",), device=device)
        device = mesh.device
    elif process_count() > 1:
        raise SystemExit("several ranks evaluate one split only together: "
                         "pass --sharded")
    ks = tuple(int(k) for k in args.ks.split(","))
    with profiler_trace(args.profile_dir):
        evalrank(args.checkpoint, data_path=args.data_path, split=args.split,
                 ks=ks, streaming=args.streaming,
                 dump_ranks=args.dump_ranks, device=device, mesh=mesh,
                 mode=args.mode)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
