"""The ``train_tower`` runner: a training cell of CMHSE whose sentence
encoder is a DeepSeek-V2 decoder stack (the configuration's ``text_tower``
section), the port's ``CMHSE(..., text_tower=...)``.

The loop, set-up's checked steps and the window are ``runners/train.py``'s:
its ``step_loop``, ``LateChecks``, ``_warm_buckets`` and ``release``, loaded
from that file. This runner supplies the model and its weights
(``harness/weights_dsv2_lite.py``), the reference
(``reference/cmhse_dsv2_lite.py``), the routing records the judge compares,
and the stack's counters read over the window (``moe.assignments``,
``tower.tokens``).

Routing. Where two experts' scores nearly tie, the program's f32 path and
the reference's can choose differently, and a flipped choice moves the
step's loss and gradients by far more than rounding. So after each checked
step the program's top-k of every expert layer is read, and the reference
repeats the step with those experts, logging its own top-k beside them.
``route_mismatch`` counts the live token-layers whose expert sets differ,
less those whose flip the reference's own scores excuse: the largest score
among its experts the program left out, less the smallest among those the
program took instead, below ``NEAR_TIE``. It counts the steps that start
from the program's own parameters: the first step and every late step. In
the second and third steps the reference's parameters are its own, and
Adam's first updates (about ``lr`` whatever a gradient's size) turn
rounding-sized gradients near zero into parameter differences of that
size, so its scores drift from the program's by far more than rounding;
those steps' flips are reported (``_route_drifted_flips``,
``_route_drifted_gap``), not compared. ``_route_flips`` counts every
differing token-layer of the compared steps and ``_route_flip_gap`` gives
the widest such gap. The TF32 control chooses its own experts and is held
to the same count.
"""

from __future__ import annotations

import time

import numpy as np

from harness import common, judge
from harness import weights_dsv2_lite as tower_weights
from harness.trace import DeviceTrace, Spans
from reference import cmhse_dsv2_lite as ref_model
from reference.data import pad_examples

train = common.load_module("runners", "train")

# The widest score gap at which a flipped expert choice is taken for a near
# tie of two f32 paths. On the compared steps (from the program's own
# parameters) the widest flip gap of sound runs was 1.38e-7 over 17 seeds
# (no flip at all on 8); the TF32 control's flips there reached 1.3e-4 to
# 1.6e-4, 197 to 235 of them past 1e-5 (PERF.md section 2).
NEAR_TIE = 1e-6


def tower_config(config: dict):
    from cmhse_tpu_torch.models.text_tower import TextTowerConfig

    return TextTowerConfig.from_dict(config["text_tower"])


def _routes(model) -> list:
    """The program's top-k of each expert layer at its last step, on the
    host."""
    return [r.to("cpu", copy=True) for r in model.text_tower.routes()]


class LateChecks(train.LateChecks):
    """``runners/train.py``'s late checks, with each checked step's routes
    read after it."""

    def __init__(self, cfg, names: list, model) -> None:
        super().__init__(cfg, names)
        self.model = model

    def after(self, state, metrics) -> None:
        routes = _routes(self.model)
        super().after(state, metrics)
        self.steps[-1]["routes"] = routes


def sized(config: dict, mix: dict, sizes: dict | None) -> tuple:
    """The configuration, with the stack's settings made from its top-level
    keys as ``text_tower`` (``harness/weights_dsv2_lite.py``'s
    ``tower_settings``), and the mix, with ``sizes``'s entries laid over
    them (the CPU tests' small shapes)."""
    config = {**config, "text_tower": tower_weights.tower_settings(config)}
    if not sizes:
        return config, mix
    config = {**config, **{k: {**config[k], **sizes.get(k, {})}
                           for k in ("data", "model", "text_tower")}}
    return config, {**mix, **sizes.get("mix", {})}


def prepare(cell: dict, config: dict, mix: dict, seed: int, device,
            hooks: dict | None = None, sizes: dict | None = None) -> dict:
    """Set-up, as ``runners/train.py``'s: the train state from the
    benchmark's weights, the split, the loop, its first three steps and its
    late steps read for the judge (with their routes), the other shapes
    warmed."""
    import torch

    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train.state import create_train_state

    hooks = hooks or {}
    config, mix = sized(config, mix, sizes)
    # first: a program without the stack fails here, before any work
    tower = tower_config(config)
    seeds = np.random.SeedSequence(seed).generate_state(3)
    cfg = train.experiment_config(config, int(seeds[2]))
    vocab = config["data"]["vocab_size"]
    cuda = device.type == "cuda"

    weights = tower_weights.make_weights(config, int(seeds[0]), device)
    model = CMHSE(cfg.model, vocab, device=device, text_tower=tower)
    model.load_state_dict(weights)
    del weights
    state = create_train_state(cfg, model)
    names = [n for n, _ in model.named_parameters()]
    dataset = common.generator(mix).split(
        mix, int(seeds[1]), cfg.data.feat_dim, vocab, torch=torch,
        device=device if cuda else None)

    spans = Spans()
    late = LateChecks(cfg, names, model)
    live_hooks = {**hooks, "before_step": late.before}
    steps = train.step_loop(state, dataset, cfg, device, spans, live_hooks)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    prog = {"losses": [], "routes": []}
    first_ids = []
    for i in range(train.COMPARED_STEPS):
        _, _, metrics, host = next(steps)
        prog["losses"].append(float(metrics["loss"]))
        prog["routes"].append(_routes(model))
        first_ids.append(np.asarray(host.video_ids)[np.asarray(host.valid)]
                         .copy())
        if i == 0:
            prog["grad_norms"] = train._adam_first_grads(state, names)
    prog["change_norms"] = {
        n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
        for n, p in model.named_parameters()}
    del start
    for _ in range(train.LATE_SEARCH):
        if late.done():
            break
        _, _, metrics, _ = next(steps)
        if late.pending is not None:
            late.after(state, metrics)
    live_hooks.pop("before_step")
    del metrics
    warmed = train._warm_buckets(state, dataset, cfg, hooks)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans.items.clear()
    return {"config": config, "cfg": cfg, "seeds": seeds, "state": state,
            "dataset": dataset, "steps": steps, "spans": spans,
            "prog": prog, "first_ids": first_ids, "late": late.steps,
            "late_buckets": [sorted(late.frames), sorted(late.words)],
            "warmed": warmed, "cuda": cuda, "device": device}


def release(T: dict) -> int:
    """``runners/train.py``'s ``release``, then the state's own tensors
    dropped (its graphs and their pool, Adam's moments, the parameters and
    their gradients), so that the reference has the card whatever still
    refers to the state; returns the device's peak memory, read first."""
    import gc

    import torch

    state = T["state"]
    if T["cuda"]:
        T["reserved_peak"] = torch.cuda.max_memory_reserved()
    peak = train.release(T)
    state.graphs.clear()
    state.graph_pool = None
    state.optimizer.state.clear()
    for p in state.model.parameters():
        p.grad = None
        p.data = torch.empty(0, device=p.device)
    del state
    gc.collect()
    if T["cuda"]:
        torch.cuda.empty_cache()
        T["held_after_release"] = torch.cuda.memory_allocated()
    return peak


def _flips(logs: list) -> tuple:
    """(live token-layers, differing ones, those past ``NEAR_TIE``, the
    widest gap) over the reference's logs of some steps: a list of steps,
    each a list of expert layers' ``{"own", "used", "scores", "live"}``."""
    rows = flips = unexcused = 0
    widest = 0.0
    for step in logs:
        for layer in step:
            own, used = layer["own"].cpu(), layer["used"].cpu()
            live = layer["live"].cpu()
            differ = ((own.sort(dim=-1).values != used.sort(dim=-1).values)
                      .any(dim=-1) & live)
            rows += int(live.sum())
            scores = layer["scores"]
            for r in differ.nonzero()[:, 0].tolist():
                mine, theirs = set(own[r].tolist()), set(used[r].tolist())
                s = scores[r].double().cpu()
                gap = (float(s[sorted(mine - theirs)].max())
                       - float(s[sorted(theirs - mine)].min()))
                flips += 1
                widest = max(widest, gap)
                if not gap < NEAR_TIE:
                    unexcused += 1
    return rows, flips, unexcused, widest


def route_numbers(logs: list, drifted: list = ()) -> dict:
    """The routing numbers (module docstring): ``logs`` the compared steps'
    reference logs, ``drifted`` those of the steps from the reference's own
    parameters."""
    rows, flips, unexcused, widest = _flips(logs)
    _, d_flips, _, d_widest = _flips(drifted)
    return {"route_mismatch": unexcused, "_route_flips": flips,
            "_route_flip_gap": widest, "_route_rows": rows,
            "_route_drifted_flips": d_flips, "_route_drifted_gap": d_widest}


def _used_routes(logs: list) -> list:
    return [[layer["used"].cpu() for layer in step] for step in logs]


def judge_steps(T: dict, tf32: bool = False) -> dict:
    """The judge's numbers: the program's first steps and late steps (or,
    with ``tf32``, the reference's in TF32 as the control) against the
    reference's given the same experts, and the routing numbers."""
    config, dataset, device = T["config"], T["dataset"], T["device"]
    ref = ref_model.Reference(config["model"], config["loss"],
                              config["text_tower"])
    seed = int(T["seeds"][0])
    if tf32:
        got = reference_steps(ref, config, dataset, T["first_ids"], seed,
                              device, tf32=True)
        routes = _used_routes(got.pop("route_logs"))
    else:
        got, routes = T["prog"], T["prog"]["routes"]
    want = reference_steps(ref, config, dataset, T["first_ids"], seed,
                           device, routes=routes)
    logs = want.pop("route_logs")
    logs, drifted = logs[:1], logs[1:]
    numbers = judge.training_numbers(got, want)
    per_step = []
    for rec in T["late"]:
        if tf32:
            got = reference_late_step(ref, config, dataset, rec, device,
                                      tf32=True)
            routes = _used_routes(got.pop("route_logs"))
        else:
            got, routes = rec, [rec["routes"]]
        want = reference_late_step(ref, config, dataset, rec, device,
                                   routes=routes)
        logs += want.pop("route_logs")
        per_step.append(judge.training_numbers(got, want))
    numbers.update(judge.late_numbers(per_step, T["late"]))
    numbers.update(route_numbers(logs, drifted))
    return numbers


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_process: float, hooks: dict | None = None,
        sizes: dict | None = None) -> dict:
    """Run the cell once; returns the result's parts, as
    ``runners/train.py``'s ``run`` does, with the stack's counters over the
    window (``assignments``, ``tokens``) for the readers."""
    import torch

    T = prepare(cell, config, mix, seed, device, hooks, sizes)
    steps, cuda = T["steps"], T["cuda"]
    tower = T["state"].model.text_tower
    before = tower.counters()
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
    after = tower.counters()
    if not np.isfinite(float(metrics["loss"])):
        log["bad_loss"] = 1
    del metrics, tower
    peak = release(T)
    out = {"setup_s": setup_s, "window_s": window_s,
           "train_videos_per_s": log["videos"] / window_s,
           "attempted": log["steps"], "failed": log["bad_loss"],
           "memory_peak_bytes": peak, "numbers": judge_steps(T),
           "info": {"warmed_buckets": T["warmed"], "steps": log["steps"],
                    "late_steps": [[r["step"], *r["shape"]]
                                   for r in T["late"]],
                    "late_buckets": T["late_buckets"],
                    "held_after_release": T.get("held_after_release"),
                    "reserved_peak": T.get("reserved_peak"),
                    "window_counters": {k: after[k] - before[k]
                                        for k in after}}}
    if dev_trace is not None:
        out["trace"] = dev_trace.analyse(T["spans"])
        out["spans"] = T["spans"]
        out["log"] = log
        out["model_cfg"] = T["config"]["model"]
        out["tower"] = T["config"]["text_tower"]
        out["assignments"] = after["moe.assignments"] - \
            before["moe.assignments"]
        out["tokens"] = after["tower.tokens"] - before["tower.tokens"]
    return out


def reference_steps(ref, config: dict, dataset, batch_ids: list,
                    weight_seed: int, device, tf32: bool = False,
                    routes: list | None = None) -> dict:
    """The reference's three steps on the benchmark's weights and the rows
    the program trained on, padded by the reference itself; ``routes``:
    each step's experts (a list of ``[R, k]`` a layer), or its own."""
    d, t = config["data"], config["train"]
    ref.tf32 = tf32
    params = tower_weights.make_weights(config, weight_seed, device)
    batches = [pad_examples([dataset[int(i)] for i in ids], d["max_clips"],
                            d["max_frames"], d["max_sentences"],
                            d["max_words"], device) for ids in batch_ids]
    for i, batch in enumerate(batches):
        if routes is not None:
            batch["routes"] = routes[i]
    return ref_model.train_steps(ref, params, batches, lr=t["lr"],
                                 grad_clip=t["grad_clip"])


def reference_late_step(ref, config: dict, dataset, rec: dict, device,
                        tf32: bool = False,
                        routes: list | None = None) -> dict:
    """The reference's step from the program's state before a late step
    (its copy on the host), as ``runners/train.py``'s, given the step's
    experts (``routes``: one step's list) or choosing its own."""
    d, t = config["data"], config["train"]
    ref.tf32 = tf32
    batch = pad_examples([dataset[int(i)] for i in rec["ids"]],
                         d["max_clips"], d["max_frames"], d["max_sentences"],
                         d["max_words"], device)
    if routes is not None:
        batch["routes"] = routes[0]
    lr = t["lr"] * t["lr_decay"] ** (rec["epoch"] // max(t["lr_update"], 1))
    moved = {k: {n: v.to(device) for n, v in rec[k].items()}
             for k in ("params", "exp_avg", "exp_avg_sq")}
    return ref_model.train_steps(
        ref, moved["params"], [batch], lr=lr, grad_clip=t["grad_clip"],
        moments=(moved["exp_avg"], moved["exp_avg_sq"], rec["adam_step"]))
