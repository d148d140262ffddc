"""Training loop, counterpart of ``cmhse_tpu/train/loop.py`` (the
reference ``train.py``'s main/train/validate trio): the epoch loop,
per-step logging, lr decay by ``lr_decay`` every ``lr_update`` epochs,
validation by rsum with a best checkpoint, mid-epoch snapshots, resume,
and a SIGTERM snapshot.

One device a process (the card unless ``device="cpu"``). Under a mesh
(``torchrun``, or ``use_mesh=True``) each rank loads and feeds its slice of
every global batch, the step is the data-parallel one of
:mod:`cmhse_tpu_torch.parallel.train_dp`, validation is sharded, and rank
0 alone writes the checkpoints and ``log.jsonl``. Batches reach each
rank's card through :class:`~cmhse_tpu_torch.data.prefetch.Prefetcher`:
pinned host buffers, copies on a side stream, two groups ahead of the
step.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from cmhse_tpu_torch.config import ExperimentConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.data.loader import batches_from_dataset
from cmhse_tpu_torch.data.prefetch import Prefetcher
from cmhse_tpu_torch.device import resolve_device
from cmhse_tpu_torch.eval.retrieval import format_table, validate_metrics
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.parallel.mesh import (make_mesh, process_count,
                                           process_index)
from cmhse_tpu_torch.parallel.train_dp import place_state
from cmhse_tpu_torch.train.checkpoint import CheckpointManager, _abs
from cmhse_tpu_torch.train.state import (create_train_state,
                                         set_learning_rate, train_step,
                                         train_steps)
from cmhse_tpu_torch.utils.logging import JsonlLogger, LogCollector


def adjust_learning_rate(cfg: ExperimentConfig, epoch: int) -> float:
    """Reference policy: lr * decay^(epoch // lr_update)."""
    t = cfg.train
    return t.lr * (t.lr_decay ** (epoch // max(t.lr_update, 1)))


def _batched(iterable, n: int):
    """``itertools.batched`` (3.12+) with a fallback for 3.10/3.11."""
    try:
        from itertools import batched
        return batched(iterable, n)
    except ImportError:
        from itertools import islice

        def gen():
            it = iter(iterable)
            while chunk := tuple(islice(it, n)):
                yield chunk

        return gen()


def _stack(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def _grouped_host_batches(group_tuples, spd: int):
    """Turn grouped host batches (tuples from ``_batched``) into
    ``(n_steps, n_pairs, host_batch)``; for ``spd > 1`` the batch is
    stacked to ``[K, B, ...]`` (the epoch's final group may be short). Takes
    the already-grouped iterator, so a mid-epoch resume skips consumed
    groups upstream without paying for their stacks."""
    for group in group_tuples:
        n_pairs = int(sum(int(np.asarray(b.valid).sum()) for b in group))
        if spd == 1:
            yield 1, n_pairs, group[0]
        else:
            yield len(group), n_pairs, Batch(**{
                f.name: _stack([getattr(b, f.name) for b in group])
                for f in dataclasses.fields(Batch)})


def build_model(cfg: ExperimentConfig, device: torch.device) -> CMHSE:
    """The run's fresh model, its weights drawn from ``cfg.train.seed``."""
    return CMHSE(cfg.model, cfg.data.vocab_size, device=device,
                 generator=torch.Generator().manual_seed(cfg.train.seed))


def fit(
    cfg: ExperimentConfig,
    train_dataset,
    val_dataset=None,
    vocab=None,
    device: str | torch.device | None = None,
    use_mesh: bool | None = None,
) -> tuple:
    """Full training run; returns (state, best_rsum).

    ``vocab``: the :class:`Vocabulary` the dataset was tokenized with;
    required when ``cfg.data.word2vec_path`` is set (the reference
    initializes its embedding table from word2vec). ``device``: where the
    run trains, the card unless ``"cpu"`` is passed. ``use_mesh``: train
    over a mesh of ``cfg.train.mesh_shape`` / ``mesh_axes`` (one rank a
    device; a world of 1 without a process group); None builds one when a
    process group is up.
    """
    device = resolve_device(device)
    mesh = None
    if use_mesh or (use_mesh is None and torch.distributed.is_initialized()):
        mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes,
                         device=device)
        device = mesh.device
        dp = mesh.shape.get("data", 1)
        if cfg.data.batch_size % dp:
            # fail here with the fix spelled out, as the JAX loop does
            raise ValueError(
                f"batch_size ({cfg.data.batch_size}) must be divisible by "
                f"the data-mesh size ({dp} devices); pass a multiple of "
                f"{dp}, or shrink TrainConfig.mesh_shape"
            )
    elif process_count() > 1:
        raise ValueError(
            "fit(use_mesh=False) is single-process only: multi-process "
            "batch placement and validation both need the global mesh")
    if vocab is not None and len(vocab) > cfg.data.vocab_size:
        # fail loud: an id past the table would index out of range (on the
        # card, a device-side assert deep inside the first step)
        raise ValueError(
            f"vocabulary has {len(vocab)} entries but "
            f"cfg.data.vocab_size={cfg.data.vocab_size}; pass "
            f"--vocab_size >= {len(vocab)} (the reference sizes the "
            f"embedding table from the built vocabulary)"
        )
    # one writer of log.jsonl: the other ranks log nothing
    logger = JsonlLogger(os.path.join(cfg.train.checkpoint_dir, "log.jsonl"),
                         enabled=process_index() == 0)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir, cfg)
    model = build_model(cfg, device)
    state = create_train_state(cfg, model)

    if cfg.data.word2vec_path:
        # reference recipe: overwrite the random embedding table with
        # pretrained vectors before training; a resume below still wins
        if vocab is None:
            raise ValueError(
                "cfg.data.word2vec_path is set but fit() got no vocab; pass "
                "the Vocabulary the dataset was tokenized with"
            )
        from cmhse_tpu_torch.data.word_vectors import \
            apply_pretrained_embeddings

        hits = apply_pretrained_embeddings(model, vocab,
                                           cfg.data.word2vec_path)
        print(f"word2vec init: {hits}/{len(vocab)} vocabulary rows "
              f"loaded from {cfg.data.word2vec_path}")
        logger.log("word2vec_init", hits=hits, vocab_size=len(vocab),
                   path=cfg.data.word2vec_path)

    start_epoch, best_rsum, start_groups = 0, -np.inf, 0
    if cfg.train.resume:
        resume_mgr = (
            ckpt if _abs(cfg.train.resume) == _abs(cfg.train.checkpoint_dir)
            else CheckpointManager(cfg.train.resume)
        )
        state, start_epoch, best_rsum, start_groups = \
            resume_mgr.restore(state)
        pos = f" (+{start_groups} dispatch groups)" if start_groups else ""
        print(f"resumed from {cfg.train.resume} at epoch {start_epoch}{pos}, "
              f"best_rsum {best_rsum:.2f}")

    if mesh is not None:
        # rank 0's parameters and Adam state on every rank, fresh or resumed
        state = place_state(state, mesh)

    # steps_per_dispatch > 1: K updates a dispatch (train_steps); needs
    # identical batch shapes, so it requires the fixed-shape loader mode.
    # Log/val cadence rounds to dispatch boundaries.
    spd = max(1, cfg.train.steps_per_dispatch)
    if spd > 1 and not cfg.data.fixed_shape:
        print("steps_per_dispatch > 1 requires fixed_shape batches; "
              "running 1 step per dispatch")
        spd = 1

    # Graceful preemption (snapshot mode only): a scheduler delivers
    # SIGTERM ahead of eviction. Catch it, finish the in-flight group, write
    # a mid-epoch snapshot, and return cleanly; the next run with resume
    # continues at the exact batch training stopped.
    preempt = {"flag": False}
    prev_sigterm = None
    if cfg.train.snapshot_step > 0:
        import signal

        def _on_sigterm(signum, frame):
            preempt["flag"] = True
            print("SIGTERM received: snapshotting after the in-flight "
                  "dispatch group, then exiting")

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            prev_sigterm = None  # not the main thread; preemption unhandled

    try:
        return _fit_epochs(cfg, train_dataset, val_dataset, state, ckpt,
                           logger, start_epoch, best_rsum, start_groups, spd,
                           preempt, mesh)
    finally:
        ckpt.close()
        if prev_sigterm is not None:
            import signal

            signal.signal(signal.SIGTERM, prev_sigterm)


def _fit_epochs(cfg, train_dataset, val_dataset, state, ckpt, logger,
                start_epoch, best_rsum, start_groups, spd, preempt, mesh):
    device = state.model.device
    prefetcher = Prefetcher(device)
    global_step = state.step
    # under a mesh each rank loads and feeds its slice of every batch
    slicing = ({} if mesh is None else
               dict(process_index=mesh.data_index,
                    process_count=mesh.data_size))
    mesh_kw = {} if mesh is None else {"mesh": mesh}
    for epoch in range(start_epoch, cfg.train.num_epochs):
        lr = adjust_learning_rate(cfg, epoch)
        state = set_learning_rate(state, lr)
        collector = LogCollector()
        t_epoch = time.time()
        n_pairs = 0

        batch_iter = batches_from_dataset(
            train_dataset, cfg.data, shuffle=True,
            seed=cfg.data.shuffle_seed + epoch,
            fixed_shape=cfg.data.fixed_shape,
            group_by_length=cfg.data.group_by_length,
            **slicing,
        )
        group_tuples = _batched(batch_iter, spd)
        groups_done = 0
        if epoch == start_epoch and start_groups > 0:
            # mid-epoch resume (snapshot_step): the per-epoch shuffle is
            # seeded, so the group stream reproduces; drop the groups the
            # snapshot already consumed, before they are stacked or copied
            from itertools import islice

            skipped = sum(1 for _ in islice(group_tuples, start_groups))
            if skipped < start_groups:
                print(f"warning: snapshot recorded {start_groups} consumed "
                      f"groups but epoch {epoch} only has {skipped}; the "
                      f"dataset or batching config changed since the save")
            groups_done = skipped
            print(f"mid-epoch resume: skipped {skipped} already-trained "
                  f"dispatch groups of epoch {epoch}")
            logger.log("resume_mid_epoch", epoch=epoch, groups=skipped)
        groups = _grouped_host_batches(group_tuples, spd)
        last_val_step = -1  # skip the end-of-epoch re-validation when the
        # val_step boundary already validated on the final dispatch group
        for (n_steps, group_pairs, _), batch in prefetcher(
                groups, batch_of=lambda g: g[2]):
            if spd > 1:
                refused = state.graph_refused
                state, metrics = train_steps(state, batch, cfg.loss,
                                             **mesh_kw)
                if state.graph_refused is not None and refused is None:
                    logger.log("graph_refused", epoch=epoch,
                               reason=state.graph_refused)
            else:
                state, metrics = train_step(state, batch, cfg.loss,
                                            **mesh_kw)
            n_pairs += group_pairs
            groups_done += 1
            prev_step, global_step = global_step, global_step + n_steps

            if (cfg.train.log_step > 0  # 0 = disabled, like val/snapshot
                    and global_step // cfg.train.log_step
                    > prev_step // cfg.train.log_step):
                means = {k: float(v.float().mean()) for k, v in
                         metrics.items()}
                for k, v in means.items():
                    collector.update(k, v)
                print(f"epoch {epoch} step {global_step} lr {lr:.2e} "
                      f"{collector}")
                logger.log("train_step", epoch=epoch, step=global_step,
                           lr=lr, **means)

            if (
                val_dataset is not None
                and cfg.train.val_step > 0
                and global_step // cfg.train.val_step
                > prev_step // cfg.train.val_step
            ):
                best_rsum = _validate_and_save(
                    cfg, state, val_dataset, ckpt, logger, epoch, best_rsum,
                    groups_done=groups_done, mesh=mesh,
                )
                last_val_step = global_step

            if (
                cfg.train.snapshot_step > 0
                and global_step // cfg.train.snapshot_step
                > prev_step // cfg.train.snapshot_step
            ):
                # preemption point: records the group offset so a resume
                # continues this epoch exactly where the stream stopped
                ckpt.save(state, epoch=epoch, best_rsum=float(best_rsum),
                          groups_done=groups_done)
                logger.log("snapshot", epoch=epoch, step=global_step,
                           groups_done=groups_done)

            if preempt["flag"]:
                ckpt.save(state, epoch=epoch, best_rsum=float(best_rsum),
                          groups_done=groups_done)
                logger.log("preempt_exit", epoch=epoch, step=global_step,
                           groups_done=groups_done)
                print(f"preemption snapshot written at step {global_step} "
                      f"(epoch {epoch}, {groups_done} groups); exiting")
                logger.close()
                return state, best_rsum

        # fence outstanding device work before timing: the steps are
        # asynchronous, so without this up to log_step - 1 in-flight steps
        # would count as done and overstate throughput
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t_epoch
        logger.log("epoch_end", epoch=epoch, seconds=dt,
                   pairs_per_sec=n_pairs / max(dt, 1e-9))

        # end-of-epoch validation + checkpoint; epoch + 1 = the next epoch
        # to run on resume (the reference saves {'epoch': epoch + 1, ...}).
        # When the val_step boundary already validated these exact
        # parameters on the final group, only the epoch marker is saved.
        if val_dataset is not None and global_step != last_val_step:
            best_rsum = _validate_and_save(
                cfg, state, val_dataset, ckpt, logger, epoch + 1, best_rsum,
                mesh=mesh,
            )
        else:
            ckpt.save(state, epoch=epoch + 1, best_rsum=float(best_rsum))

    logger.close()
    return state, best_rsum


def _validate_and_save(cfg, state, val_dataset, ckpt, logger, epoch,
                       best_rsum, groups_done=0, mesh=None):
    # under a mesh each rank encodes its slice of every batch
    slicing = ({} if mesh is None else
               dict(process_index=mesh.data_index,
                    process_count=mesh.data_size))
    batches = batches_from_dataset(val_dataset, cfg.data, shuffle=False,
                                   **slicing)
    metrics = validate_metrics(state.model, batches, ks=(1, 5, 10, 50),
                               mesh=mesh)
    print(format_table(metrics))
    logger.log("validate", epoch=epoch, step=int(state.step), **metrics)
    rsum = float(metrics["rsum"])
    if not np.isfinite(rsum):
        # diverged validation: max(NaN, x) is NaN and would poison
        # best_rsum for the rest of the run; keep the tracked best and the
        # best checkpoint untouched instead
        print(f"warning: non-finite validation rsum ({rsum}); best "
              "checkpoint left unchanged")
        ckpt.save(state, epoch=epoch, best_rsum=float(best_rsum),
                  is_best=False, groups_done=groups_done)
        return best_rsum
    is_best = rsum > best_rsum
    ckpt.save(state, epoch=epoch, best_rsum=float(max(rsum, best_rsum)),
              is_best=is_best, groups_done=groups_done)
    return max(rsum, best_rsum)
