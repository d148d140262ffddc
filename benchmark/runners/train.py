"""The ``train`` runner: a training cell, the per-step path of
``cmhse_tpu_torch.train.loop``'s ``_fit_epochs`` (the seeded per-epoch
shuffle, ``batches_from_dataset`` with the native packer,
``_grouped_host_batches``, the ``Prefetcher``'s pinned ring,
``train_step``, the loop's metrics read every ``log_step`` steps), over a
split held in host memory, epochs rolling over inside the window.
Validation and snapshots are not run.

Set-up builds one train state from the benchmark's weights and drives it
by the window's own loop: through its first three steps (their rows all
differ), which the reference replays from the same weights, and on until
the prefetcher's pinned ring has wrapped, ``LATE_STEPS`` steps have been
checked past that, and every frame and word bucket of the configuration
has had a checked step. Before each such late step the program's state is
copied to the host, and the reference repeats the step from that copy.
Then the cell's other batch shapes are warmed, and the same state and
loop go to the window.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np

from harness import common, judge
from harness.trace import DeviceTrace, Spans
from harness.weights import make_weights
from reference import cmhse as ref_model
from reference.data import pad_examples

COMPARED_STEPS = 3  # from the seed's weights, replayed by the reference
LATE_STEPS = 3  # late steps checked at the least
LATE_SEARCH = 64  # set-up steps past the first three, at the most


def experiment_config(config: dict, seed: int):
    from cmhse_tpu_torch.config import ExperimentConfig

    raw = {k: config[k] for k in ("data", "model", "loss", "train")}
    raw["train"] = {**raw["train"], "seed": seed % 2**31}
    raw["data"] = {**raw["data"], "shuffle_seed": seed % 2**31}
    raw["name"] = config["name"]
    return ExperimentConfig.from_json(json.dumps(raw))


def _lengths(host) -> dict:
    return {"frame_len": host.frame_len, "word_len": host.word_len,
            "clip_len": host.clip_len, "sent_len": host.sent_len,
            "valid": host.valid, "frames": int(host.frames.shape[2]),
            "words": int(host.words.shape[2])}


def step_loop(state, dataset, cfg, device, spans: Spans, hooks: dict):
    """The loop's per-step path; yields ``(pairs, lengths, metrics,
    host batch)`` after each step, forever (epochs roll over). ``hooks``:
    ``train_step`` replaces the program's (the fault tests);
    ``before_step(state, host batch, epoch, pinned slots)``, read at
    every step, is called before each step (set-up's late checks)."""
    from cmhse_tpu_torch.data.loader import batches_from_dataset
    from cmhse_tpu_torch.data.prefetch import Prefetcher
    from cmhse_tpu_torch.train import loop
    from cmhse_tpu_torch.train.state import set_learning_rate

    train_step = hooks.get("train_step") or loop.train_step
    prefetcher = Prefetcher(device)
    global_step = state.step
    log_step = cfg.train.log_step
    for epoch in itertools.count():
        state = set_learning_rate(state, loop.adjust_learning_rate(cfg,
                                                                   epoch))
        batch_iter = batches_from_dataset(
            dataset, cfg.data, shuffle=True,
            seed=cfg.data.shuffle_seed + epoch,
            fixed_shape=cfg.data.fixed_shape,
            group_by_length=cfg.data.group_by_length)
        groups = loop._grouped_host_batches(loop._batched(batch_iter, 1), 1)
        stream = iter(prefetcher(groups, batch_of=lambda g: g[2]))
        while True:
            with spans("batch_wait"):
                item = next(stream, None)
            if item is None:
                break
            (_, pairs, host), batch = item
            before = hooks.get("before_step")
            if before is not None:
                before(state, host, epoch, len(prefetcher.slots))
            with spans("train_step"):
                state, metrics = train_step(state, batch, cfg.loss)
            prev, global_step = global_step, global_step + 1
            if log_step > 0 and global_step // log_step > prev // log_step:
                with spans("log_read"):
                    {k: float(v.float().mean()) for k, v in metrics.items()}
            yield pairs, _lengths(host), metrics, host


def _adam_first_grads(state, names: list) -> dict:
    """Per-leaf norm of the gradient Adam took at its first step, from its
    first moment: ``m_1 = (1 - beta1) g``."""
    import torch

    opt = state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for name, p in zip(names, opt.param_groups[0]["params"]):
        m = opt.state[p]["exp_avg"]
        out[name] = float(torch.linalg.vector_norm(m.double())) / (1 - beta1)
    return out


class LateChecks:
    """The late steps set-up checks: each step whose batch came through a
    pinned slot used before (the ring has wrapped), while fewer than
    ``LATE_STEPS`` were checked or its frame or word bucket has not been.
    Before such a step the program's state (parameters, Adam's moments and
    step count) is copied to the host for the reference; after it, the
    program's loss and the per-leaf norms of its gradient (from Adam's
    first moment, before and after) and of its change are read."""

    def __init__(self, cfg, names: list) -> None:
        d = cfg.data
        self.names = names
        self.frames_wanted = ({d.max_frames} if d.fixed_shape
                              else set(d.frame_buckets))
        self.words_wanted = ({d.max_words} if d.fixed_shape
                             else set(d.word_buckets))
        self.frames, self.words = set(), set()
        self.steps: list = []
        self.pending: dict | None = None

    def done(self) -> bool:
        return (len(self.steps) >= LATE_STEPS
                and self.frames >= self.frames_wanted
                and self.words >= self.words_wanted)

    def before(self, state, host, epoch: int, ring: int) -> None:
        number = state.step + 1
        f, w = int(host.frames.shape[2]), int(host.words.shape[2])
        if number <= ring or (len(self.steps) >= LATE_STEPS
                                   and f in self.frames and w in self.words):
            return
        self.frames.add(f)
        self.words.add(w)
        params = list(state.model.parameters())
        adam = [state.optimizer.state[p] for p in params]
        self.pending = {
            "step": number, "epoch": epoch, "shape": [f, w],
            "ids": np.asarray(host.video_ids)[np.asarray(host.valid)].copy(),
            "params": {n: p.detach().to("cpu", copy=True)
                       for n, p in zip(self.names, params)},
            "exp_avg": {n: a["exp_avg"].to("cpu", copy=True)
                        for n, a in zip(self.names, adam)},
            "exp_avg_sq": {n: a["exp_avg_sq"].to("cpu", copy=True)
                           for n, a in zip(self.names, adam)},
            "adam_step": int(float(adam[0]["step"])),
            "_p": [p.detach().clone() for p in params],
            "_m": [a["exp_avg"].clone() for a in adam]}

    def after(self, state, metrics) -> None:
        import torch

        rec, self.pending = self.pending, None
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        params = list(state.model.parameters())
        rec["losses"] = [float(metrics["loss"])]
        rec["grad_norms"], rec["change_norms"] = {}, {}
        for n, p, p0, m0 in zip(self.names, params, rec.pop("_p"),
                                rec.pop("_m")):
            m = state.optimizer.state[p]["exp_avg"]
            rec["grad_norms"][n] = float(torch.linalg.vector_norm(
                (m - beta1 * m0).double())) / (1 - beta1)
            rec["change_norms"][n] = float(torch.linalg.vector_norm(
                (p.detach() - p0).double()))
        self.steps.append(rec)


def _warm_buckets(state, dataset, cfg, hooks) -> int:
    """One step at each (frames, words) bucket the loader can emit, on the
    split's first rows packed to that bucket by the program's packer; a
    fixed-shape cell has one shape, which its first steps warmed."""
    if cfg.data.fixed_shape:
        return 0
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.data.bucketing import BucketSpec
    from cmhse_tpu_torch.train import loop

    train_step = hooks.get("train_step") or loop.train_step
    d = cfg.data
    rows = [dataset[i] for i in range(min(len(dataset), d.batch_size))]
    n = 0
    for f in d.frame_buckets:
        for w in d.word_buckets:
            spec = BucketSpec(batch_size=d.batch_size, max_clips=d.max_clips,
                              max_frames=f, max_sentences=d.max_sentences,
                              max_words=w, feat_dim=d.feat_dim,
                              feature_dtype=d.feature_dtype)
            batch = native.pack_batch_native(rows, spec)
            train_step(state, batch.to(state.model.device), cfg.loss)
            n += 1
    return n


def prepare(cell: dict, config: dict, mix: dict, seed: int, device,
            hooks: dict | None = None, sizes: dict | None = None) -> dict:
    """Set-up: the train state from the benchmark's weights, the split,
    the loop, its first three steps and its late steps read for the judge,
    the other shapes warmed."""
    import torch

    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train.state import create_train_state

    hooks = hooks or {}
    if sizes:
        config = {**config, **{k: {**config[k], **sizes.get(k, {})}
                               for k in ("data", "model")}}
        mix = {**mix, **sizes.get("mix", {})}
    seeds = np.random.SeedSequence(seed).generate_state(3)
    cfg = experiment_config(config, int(seeds[2]))
    model_cfg, vocab = config["model"], config["data"]["vocab_size"]
    cuda = device.type == "cuda"

    weights = make_weights(model_cfg, vocab, int(seeds[0]), device)
    model = CMHSE(cfg.model, vocab, device=device)
    model.load_state_dict(weights)
    del weights
    state = create_train_state(cfg, model)
    names = [n for n, _ in model.named_parameters()]
    dataset = common.generator(mix).split(
        mix, int(seeds[1]), cfg.data.feat_dim, vocab, torch=torch,
        device=device if cuda else None)

    spans = Spans()
    late = LateChecks(cfg, names)
    live_hooks = {**hooks, "before_step": late.before}
    steps = step_loop(state, dataset, cfg, device, spans, live_hooks)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    prog = {"losses": []}
    first_ids = []
    for i in range(COMPARED_STEPS):
        _, _, metrics, host = next(steps)
        prog["losses"].append(float(metrics["loss"]))
        first_ids.append(np.asarray(host.video_ids)[np.asarray(host.valid)]
                         .copy())
        if i == 0:
            prog["grad_norms"] = _adam_first_grads(state, names)
    prog["change_norms"] = {
        n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
        for n, p in model.named_parameters()}
    for _ in range(LATE_SEARCH):
        if late.done():
            break
        _, _, metrics, _ = next(steps)
        if late.pending is not None:
            late.after(state, metrics)
    live_hooks.pop("before_step")
    del start, metrics
    warmed = _warm_buckets(state, dataset, cfg, hooks)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans.items.clear()
    return {"config": config, "cfg": cfg, "seeds": seeds, "state": state,
            "dataset": dataset, "steps": steps, "spans": spans,
            "prog": prog, "first_ids": first_ids, "late": late.steps,
            "late_buckets": [sorted(late.frames), sorted(late.words)],
            "warmed": warmed,
            "cuda": cuda, "device": device}


def release(T: dict) -> int:
    """Close the loop and free the program's state; returns the device's
    peak memory, read first."""
    import torch

    peak = torch.cuda.max_memory_allocated() if T["cuda"] else 0
    T.pop("steps").close()
    T.pop("state")
    if T["cuda"]:
        torch.cuda.empty_cache()
    return peak


def judge_steps(T: dict, tf32: bool = False) -> dict:
    """The judge's numbers: the program's first steps and late steps (or,
    with ``tf32``, the reference's in TF32 as the control) against the
    reference's."""
    config, dataset, device = T["config"], T["dataset"], T["device"]
    ref = ref_model.Reference(config["model"], config["loss"])
    seed = int(T["seeds"][0])
    want = reference_steps(ref, config, dataset, T["first_ids"], seed,
                           device)
    got = T["prog"]
    if tf32:
        got = reference_steps(ref, config, dataset, T["first_ids"], seed,
                              device, tf32=True)
    numbers = judge.training_numbers(got, want)
    per_step = []
    for rec in T["late"]:
        want = reference_late_step(ref, config, dataset, rec, device)
        got = rec
        if tf32:
            got = reference_late_step(ref, config, dataset, rec, device,
                                      tf32=True)
        per_step.append(judge.training_numbers(got, want))
    numbers.update(judge.late_numbers(per_step, T["late"]))
    return numbers


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_process: float, hooks: dict | None = None,
        sizes: dict | None = None) -> dict:
    """Run the cell once; returns the result's parts. ``hooks`` replace
    program calls (the fault tests); ``sizes`` overrides configuration and
    mix entries (the CPU tests' small shapes)."""
    import torch

    T = prepare(cell, config, mix, seed, device, hooks, sizes)
    steps, cuda = T["steps"], T["cuda"]
    log = {"steps": 0, "videos": 0, "lengths": [], "bad_loss": 0}
    dev_trace = DeviceTrace(torch) if trace else None
    if dev_trace is not None:
        dev_trace.__enter__()
    t0 = time.perf_counter()
    setup_s = time.time() - t_process
    while True:
        pairs, lengths, metrics, _ = next(steps)
        log["steps"] += 1
        log["videos"] += pairs
        if trace:
            log["lengths"].append(lengths)
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if dev_trace is not None:
        dev_trace.__exit__(None, None, None)
    window_s = t1 - t0
    if not np.isfinite(float(metrics["loss"])):
        log["bad_loss"] = 1
    del metrics
    peak = release(T)
    out = {"setup_s": setup_s, "window_s": window_s,
           "train_videos_per_s": log["videos"] / window_s,
           "attempted": log["steps"], "failed": log["bad_loss"],
           "memory_peak_bytes": peak, "numbers": judge_steps(T),
           "info": {"warmed_buckets": T["warmed"], "steps": log["steps"],
                    "late_steps": [[r["step"], *r["shape"]]
                                   for r in T["late"]],
                    "late_buckets": T["late_buckets"]}}
    if dev_trace is not None:
        out["trace"] = dev_trace.analyse(T["spans"])
        out["spans"] = T["spans"]
        out["log"] = log
        out["model_cfg"] = T["config"]["model"]
    return out


def reference_steps(ref, config: dict, dataset, batch_ids: list,
                    weight_seed: int, device, tf32: bool = False) -> dict:
    """The reference's three steps on the benchmark's weights and the rows
    the program trained on, padded by the reference itself."""
    d, t = config["data"], config["train"]
    ref.tf32 = tf32
    params = make_weights(config["model"], d["vocab_size"], weight_seed,
                          device)
    batches = [pad_examples([dataset[int(i)] for i in ids], d["max_clips"],
                            d["max_frames"], d["max_sentences"],
                            d["max_words"], device) for ids in batch_ids]
    return ref_model.train_steps(ref, params, batches, lr=t["lr"],
                                 grad_clip=t["grad_clip"])


def reference_late_step(ref, config: dict, dataset, rec: dict, device,
                        tf32: bool = False) -> dict:
    """The reference's step from the program's state before a late step
    (its copy on the host), on the step's rows padded by the reference
    itself, at the configuration's rate for the step's epoch."""
    d, t = config["data"], config["train"]
    ref.tf32 = tf32
    batch = pad_examples([dataset[int(i)] for i in rec["ids"]],
                         d["max_clips"], d["max_frames"], d["max_sentences"],
                         d["max_words"], device)
    lr = t["lr"] * t["lr_decay"] ** (rec["epoch"] // max(t["lr_update"], 1))
    moved = {k: {n: v.to(device) for n, v in rec[k].items()}
             for k in ("params", "exp_avg", "exp_avg_sq")}
    return ref_model.train_steps(
        ref, moved["params"], [batch], lr=lr, grad_clip=t["grad_clip"],
        moments=(moved["exp_avg"], moved["exp_avg_sq"], rec["adam_step"]))
