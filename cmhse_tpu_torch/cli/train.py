"""``python -m cmhse_tpu_torch.cli.train``, counterpart of ``cmhse-train``
(the reference's ``python train.py``): the reference's flags mapped onto the
frozen dataclass config, ``--preset`` choosing a BASELINE config by name,
then :func:`cmhse_tpu_torch.train.loop.fit` on the card (or the CPU with
``--platform cpu``). Several cards train data-parallel under ``torchrun
--nproc_per_node=N -m cmhse_tpu_torch.cli.train ...``: each process takes
one card, and ``fit`` builds the mesh of ``TrainConfig.mesh_shape``.
"""

from __future__ import annotations

import argparse
import dataclasses

from cmhse_tpu_torch.cli import add_platform_flag, device_for

# Flags of the JAX command with no counterpart here: on the card the CUDA
# kernels always run, so a switch to the plain path would be a fallback on
# the main path, and there is no XLA compile to cache.
JAX_ONLY_FLAGS = ("--pallas_gru", "--no_pallas_gru", "--compile_cache")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.train")
    p.add_argument("--preset", default="hier_anet",
                   help="named BASELINE config (see "
                        "cmhse_tpu_torch.config.PRESETS)")
    # the reference's flags
    p.add_argument("--data_path", default=None)
    p.add_argument("--data_name", dest="dataset", default=None,
                   help="e.g. anet_precomp / didemo_precomp")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--word2vec_path", default=None,
                   help="pretrained word vectors (word2vec .txt, C-binary "
                        ".bin, or .npz) the embedding table starts from")
    p.add_argument("--margin", type=float, default=None)
    p.add_argument("--feat_dim", type=int, default=None,
                   help="video feature dim (500 for the C3D-PCA release)")
    p.add_argument("--embed_size", type=int, default=None)
    p.add_argument("--word_dim", type=int, default=None)
    p.add_argument("--rnn_hidden", type=int, default=None,
                   help="GRU hidden size (default 1024, the reference's)")
    p.add_argument("--vocab_size", type=int, default=None)
    # sequence caps (static batch shapes)
    p.add_argument("--max_clips", type=int, default=None)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--max_sentences", type=int, default=None)
    p.add_argument("--max_words", type=int, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", "--learning_rate", type=float, default=None)
    p.add_argument("--lr_update", type=int, default=None)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--max_violation", action="store_true", default=None)
    p.add_argument("--no_max_violation", dest="max_violation",
                   action="store_false")
    p.add_argument("--resume", default=None)
    p.add_argument("--logger_name", dest="checkpoint_dir", default=None)
    p.add_argument("--val_step", type=int, default=None)
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="update steps a dispatch, replayed as one CUDA "
                        "graph (train_steps; fixed-shape batches only)")
    p.add_argument("--log_step", type=int, default=None)
    p.add_argument("--snapshot_step", type=int, default=None,
                   help="save a mid-epoch-resumable checkpoint every N steps "
                        "(0 = per-epoch only); --resume then continues the "
                        "interrupted epoch at the batch it stopped")
    p.add_argument("--seed", type=int, default=None)
    # model structure
    p.add_argument("--flat", action="store_true",
                   help="non-hierarchical VSE-style model (config 1)")
    p.add_argument("--attention_pool", action="store_true", default=None)
    p.add_argument("--reconstruction", action="store_true", default=None)
    p.add_argument("--recon_weight", type=float, default=None, help="tau")
    p.add_argument("--low_weight", type=float, default=None)
    p.add_argument("--high_weight", type=float, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--feature_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="dtype of the loader's frame features; bf16 halves "
                        "the copy and gives a bf16 model the same inputs. "
                        "Default: follows --dtype")
    p.add_argument("--bucketed", action="store_true", default=None,
                   help="length-bucketed batches (fixed_shape=False + "
                        "group_by_length)")
    p.add_argument("--fixed_shape", dest="bucketed", action="store_false",
                   help="force single-bucket maximal-cap batches")
    # runtime
    add_platform_flag(p)
    p.add_argument("--profile_dir", default=None,
                   help="record the run with torch.profiler and write a "
                        "Chrome trace into this dir")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset")
    p.add_argument("--synthetic_videos", type=int, default=256)
    p.add_argument("--correlated", action="store_true",
                   help="with --synthetic: the cross-modally correlated "
                        "generator (learnable)")
    return p


def apply_overrides(cfg, args):
    """The preset with every explicitly passed flag applied."""
    d = dataclasses.asdict(cfg.data)
    m = dataclasses.asdict(cfg.model)
    l = dataclasses.asdict(cfg.loss)
    t = dataclasses.asdict(cfg.train)
    if args.data_path is not None:
        d["data_path"] = args.data_path
    if args.dataset is not None:
        d["dataset"] = args.dataset
    if args.word2vec_path is not None:
        d["word2vec_path"] = args.word2vec_path
    if args.bucketed is not None:
        d["fixed_shape"] = not args.bucketed
        d["group_by_length"] = args.bucketed
    if args.batch_size is not None:
        d["batch_size"] = args.batch_size
    if args.feat_dim is not None:
        d["feat_dim"] = args.feat_dim
        m["feat_dim"] = args.feat_dim
    if args.embed_size is not None:
        m["embed_size"] = args.embed_size
    if args.word_dim is not None:
        m["word_dim"] = args.word_dim
    if args.rnn_hidden is not None:
        m["rnn_hidden"] = args.rnn_hidden
    if args.vocab_size is not None:
        d["vocab_size"] = args.vocab_size
    for cap in ("max_clips", "max_frames", "max_sentences", "max_words"):
        v = getattr(args, cap)
        if v is not None:
            d[cap] = v
    if args.flat:
        m["hierarchical"] = False
        # the flat model takes one whole-video clip and the joined paragraph
        d["max_clips"] = 1
        d["max_sentences"] = 1
        # and has no hierarchy to reconstruct: --flat on a recon preset
        # drops the term; an explicit --reconstruction still reaches the
        # config's refusal
        if args.reconstruction is None:
            m["reconstruction"] = False
    if args.attention_pool is not None:
        m["attention_pool"] = args.attention_pool
    if args.reconstruction is not None:
        m["reconstruction"] = args.reconstruction
    if args.dtype is not None:
        m["dtype"] = args.dtype
    if args.feature_dtype is not None:
        d["feature_dtype"] = args.feature_dtype
    elif m["dtype"] == "bfloat16" and d.get("feature_dtype") == "float32":
        # a bf16 model rounds its inputs at once: bf16 features give it
        # the same values at half the bytes
        d["feature_dtype"] = "bfloat16"
    if args.margin is not None:
        l["margin"] = args.margin
    if args.max_violation is not None:
        l["max_violation"] = args.max_violation
    if args.recon_weight is not None:
        l["recon_weight"] = args.recon_weight
    if args.low_weight is not None:
        l["low_weight"] = args.low_weight
    if args.high_weight is not None:
        l["high_weight"] = args.high_weight
    for name in ("num_epochs", "lr", "lr_update", "grad_clip", "val_step",
                 "log_step", "snapshot_step", "seed", "resume",
                 "checkpoint_dir", "steps_per_dispatch"):
        v = getattr(args, name)
        if v is not None:
            t[name] = v
    from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig,
                                        LossConfig, ModelConfig, TrainConfig)

    return ExperimentConfig(
        name=cfg.name,
        data=DataConfig(**d),
        model=ModelConfig(**m),
        loss=LossConfig(**l),
        train=TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in t.items()}),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)

    from cmhse_tpu_torch.parallel.mesh import maybe_initialize_distributed

    # under torchrun: the process group from its environment (a no-op
    # otherwise), as the JAX command initializes jax.distributed
    maybe_initialize_distributed(device)

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      find_vocab)
    from cmhse_tpu_torch.train.loop import fit
    from cmhse_tpu_torch.utils.timing import profiler_trace

    cfg = apply_overrides(get_preset(args.preset), args)
    print(f"config:\n{cfg.to_json()}")

    vocab = None
    if args.synthetic:
        from cmhse_tpu_torch.data import (CorrelatedSyntheticDataset,
                                          SyntheticHierarchicalDataset)

        ds_cls = (CorrelatedSyntheticDataset if args.correlated
                  else SyntheticHierarchicalDataset)

        def mk(n, seed):
            return ds_cls(
                num_videos=n, feat_dim=cfg.data.feat_dim,
                vocab_size=cfg.data.vocab_size,
                max_clips=cfg.data.max_clips,
                max_frames=cfg.data.max_frames,
                max_words=cfg.data.max_words, seed=seed)

        train_ds = mk(args.synthetic_videos, 0)
        val_ds = mk(max(args.synthetic_videos // 4, 8), 1)
        if cfg.data.word2vec_path:
            # synthetic token ids carry no words: vectors need a vocabulary
            if not args.vocab_path:
                raise SystemExit(
                    "--word2vec_path with --synthetic requires --vocab_path")
            vocab = Vocabulary.load(args.vocab_path)
    else:
        vocab = Vocabulary.load(find_vocab(cfg.data.data_path,
                                           args.vocab_path))
        flat = not cfg.model.hierarchical
        train_ds = PrecompDataset(cfg.data.data_path, "train", vocab,
                                  feat_dim=cfg.data.feat_dim, flat=flat)
        val_ds = PrecompDataset(cfg.data.data_path, "val", vocab,
                                feat_dim=cfg.data.feat_dim, flat=flat)

    with profiler_trace(args.profile_dir):
        _, best_rsum = fit(cfg, train_ds, val_ds, vocab=vocab, device=device)
    print(f"done; best rsum {best_rsum:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
