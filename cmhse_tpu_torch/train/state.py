"""Train state and the update step, counterpart of
``cmhse_tpu/train/state.py``: forward, loss, backward, global-norm clip,
Adam.

The model's parameters are updated in place (the JAX step donates its
state and returns a new one; here the returned state is the one passed in,
its ``step`` advanced). :func:`train_steps` runs K updates over a stacked
batch, the counterpart of the JAX package's one-dispatch ``lax.scan``.

On the card both run as the replay of a CUDA graph, captured once for each
shape of their batch (:func:`_dispatch`): :func:`train_step` a graph of one
step, :func:`train_steps` one of its K steps. The first batch of a shape
runs eagerly, and the step is captured after it; each later batch of that
shape is copied into the graph's inputs and replayed, so the host launches
no kernel of the step. On the CPU every step runs eagerly.

On the card Adam is built with ``capturable=True`` and a tensor learning
rate, so that a captured step reads its rate and its step count from the
device: :func:`set_learning_rate` then writes into that tensor and never
needs a new capture.

With a ``mesh`` (:mod:`cmhse_tpu_torch.parallel`) the step is the
data-parallel one: each rank feeds its rows of the global batch, and the
loss is the JAX package's global one (see
:mod:`cmhse_tpu_torch.parallel.train_dp`); every rank ends the step with
the same parameters.

With the recorder on (:mod:`cmhse_tpu_torch.utils.timing`), an eager step
records the spans ``step.forward``, ``step.loss``, ``step.backward`` and
``step.update`` (zero gradients for parameters that got none, the global
norm, the clip and Adam), a replay of a captured step one ``step.replay``
span, :func:`create_train_state` one ``state.init``. A capture records no
span; it adds one to the ``step.captures`` counter.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field

import torch

from cmhse_tpu_torch.config import ExperimentConfig, LossConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.models.cmhse import CMHSE
from cmhse_tpu_torch.parallel import train_dp
from cmhse_tpu_torch.train.objective import total_loss
from cmhse_tpu_torch.utils import timing


@dataclass
class TrainState:
    """The model, its optimizer, the clip threshold and the step count."""

    model: CMHSE
    optimizer: torch.optim.Optimizer
    grad_clip: float
    step: int = 0
    # on the card: a CUDA graph of a step (train_step) or of K steps
    # (train_steps) by the batch's shapes and dtypes, and how many times
    # one was replayed
    graphs: dict = field(default_factory=dict, repr=False)
    graph_replays: int = 0
    # why the card refused to capture a step (every step then runs
    # eagerly); None while captures succeed
    graph_refused: str | None = None
    # the memory pool all of this state's graphs capture into, and the
    # stream that runs a shape's first step and its capture (_dispatch)
    graph_pool: tuple | None = field(default=None, init=False, repr=False)
    graph_stream: object = field(default=None, init=False, repr=False)

    def state_dict(self) -> dict:
        """The model's and Adam's ``state_dict`` and the step count."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        """Load :meth:`state_dict` output, written on any device. The
        parameters are copied into place; Adam's moments and step counts
        move to the parameters' device. The groups keep this optimizer's
        own settings (``capturable`` differs between the card and the CPU)
        and learning-rate objects, which take the saved rate's value.
        Captured graphs are dropped, and their pool with them: they read
        Adam's old state tensors, which this replaces. The parameters keep
        their storage (``nn.Module.load_state_dict`` copies into it), as
        they do under ``CMHSE.load_jax_params`` and
        ``parallel.place_state``, so a graph stays valid across those."""
        self.model.load_state_dict(sd["model"])
        rates = [g["lr"] for g in self.optimizer.param_groups]
        saved = sd["optimizer"]
        # Adam places each loaded value by the groups' flags: give it this
        # optimizer's own (a capturable one keeps its step counts on the
        # parameters' device)
        groups = [{**sg, **{k: v for k, v in g.items()
                            if k not in ("params", "lr")}}
                  for sg, g in zip(saved["param_groups"],
                                   self.optimizer.param_groups)]
        self.optimizer.load_state_dict({"state": saved["state"],
                                        "param_groups": groups})
        for group, rate in zip(self.optimizer.param_groups, rates):
            value = float(group["lr"])
            if isinstance(rate, torch.Tensor):
                rate.fill_(value)
                group["lr"] = rate
            else:
                group["lr"] = value
        self.step = int(sd["step"])
        self.graphs.clear()
        self.graph_pool = None


def make_optimizer(model: torch.nn.Module,
                   cfg: ExperimentConfig) -> torch.optim.Adam:
    """Adam at ``cfg.train.lr`` with optax's defaults: betas (0.9, 0.999),
    eps 1e-8 added outside the square root. The clip at
    ``cfg.train.grad_clip`` runs in :func:`train_step`, before it. On the
    card: ``capturable=True`` with the rate in a device tensor (see the
    module docstring)."""
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    lr = (torch.tensor(cfg.train.lr, dtype=torch.float32, device=device)
          if cuda else cfg.train.lr)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, capturable=cuda)


def create_train_state(cfg: ExperimentConfig, model: CMHSE) -> TrainState:
    """A fresh state for ``model`` (built by the caller, on its device)."""
    with timing.span("state.init"):
        return TrainState(model=model, optimizer=make_optimizer(model, cfg),
                          grad_clip=cfg.train.grad_clip)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The reference's per-epoch ``adjust_learning_rate``: set the lr (in
    place on the card, where a captured step reads it)."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return state


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place: each gradient becomes
    ``(g / norm) * max_norm`` when ``norm >= max_norm`` and stays as it is
    otherwise (``torch.nn.utils.clip_grad_norm_`` differs: it scales by
    ``max_norm / (norm + 1e-6)``). Decided on the device, with no host
    sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def _untimed(name: str):
    return contextlib.nullcontext()


def _update(state: TrainState, batch: Batch, loss_cfg: LossConfig,
            mesh=None, timed: bool = True) -> dict[str, torch.Tensor]:
    """One optimisation step on a batch on the model's device, leaving
    ``state.step`` alone (shared body of :func:`train_step` and
    :func:`train_steps`, and what a graph captures, with ``timed`` False:
    no spans). With ``mesh``, the batch is this rank's rows and the loss
    the global batch's."""
    span = timing.span if timed else _untimed
    model = state.model
    params = list(model.parameters())
    for p in params:
        p.grad = None
    with span("step.forward"):
        outputs = model(batch)
    with span("step.loss"):
        if mesh is not None:
            outputs, batch = train_dp.gather_global(outputs, batch, mesh)
        loss, metrics = total_loss(outputs, batch, loss_cfg)
    with span("step.backward"):
        loss.backward()
    with span("step.update"):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if mesh is not None:
            train_dp.all_reduce_gradients(grads, mesh)
        with torch.no_grad():
            norm = global_norm(grads)
        clip_by_global_norm_(grads, state.grad_clip, norm)
        state.optimizer.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = norm
    return metrics


def train_step(state: TrainState, batch: Batch, loss_cfg: LossConfig,
               mesh=None) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimisation step; returns (state, metrics). Metrics are 0-d
    tensors on the model's device: the loss terms of :func:`total_loss`
    and ``grad_norm``, the global norm before clipping. A parameter that
    gets no gradient is given zeros, so Adam updates it as optax does. A
    batch already on the model's device is not copied. ``mesh``: the
    data-parallel step over this rank's rows of the global batch (the
    state placed by ``parallel.place_state``).

    On the card the step is the replay of a graph captured for the
    batch's shapes (:func:`_dispatch`); a replayed step leaves no
    ``.grad`` on the parameters (the first, eager step of a shape leaves
    its gradients, as every step does on the CPU)."""
    return _dispatch(state, batch, loss_cfg, mesh, _update, 1)


def _unstack(stacked: Batch, i: int) -> Batch:
    return Batch(**{f.name: getattr(stacked, f.name)[i]
                    for f in dataclasses.fields(Batch)})


def _steps(state: TrainState, stacked: Batch, loss_cfg: LossConfig,
           mesh=None, timed: bool = True) -> dict[str, torch.Tensor]:
    """The K updates of ``stacked`` in order, metrics stacked ``[K]``."""
    out = [_update(state, _unstack(stacked, i), loss_cfg, mesh, timed)
           for i in range(stacked.frames.shape[0])]
    return {k: torch.stack([m[k] for m in out]) for k in out[0]}


def train_steps(state: TrainState, stacked: Batch, loss_cfg: LossConfig,
                mesh=None) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """K optimisation steps over a stacked :class:`Batch` whose fields
    carry a leading ``[K, ...]`` axis: exactly the math and order of K
    :func:`train_step` calls. Metrics come back with a leading ``[K]``
    axis. On the CPU the steps run one after another; on the card they
    are one replay of a graph of the K steps (:func:`_dispatch`)."""
    return _dispatch(state, stacked, loss_cfg, mesh, _steps,
                     stacked.frames.shape[0])


def _shape_key(batch: Batch) -> tuple:
    """Each field's name, shape and dtype: batches with the same key run
    the same captured graph."""
    return tuple((f.name, tuple(getattr(batch, f.name).shape),
                  getattr(batch, f.name).dtype)
                 for f in dataclasses.fields(Batch))


def _capture_refused(e: RuntimeError) -> bool:
    """Whether ``e`` is CUDA's or NCCL's refusal of a stream capture (an
    operation the capture does not allow), rather than a failure of the
    step itself, such as a kernel's launch or a collective."""
    return "captur" in str(e).lower()


def _dispatch(state: TrainState, batch: Batch, loss_cfg: LossConfig, mesh,
              run, k: int) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """``run`` (:func:`_update` or :func:`_steps`) on ``batch``, then
    ``state.step`` advanced by ``k``.

    On the CPU, and after the card refused a capture, ``run`` runs
    eagerly. On the card it runs as the replay of a CUDA graph keyed by
    the batch's shapes and dtypes, ``run``, the loss config and the mesh.
    The first batch of a key runs eagerly (with its ``step.*`` spans) on
    the state's side stream, which sets up Adam's state, the kernels and
    cuBLAS's workspace for that stream; the step is then captured on
    static input buffers. Each later batch of the key is copied into those
    buffers and the graph replayed. Replays launch no kernel from the
    host, so they add nothing to ``cuda_lib.launches``;
    ``state.graph_replays`` counts them.

    With ``mesh`` the graph holds the step's NCCL collectives too. If the
    card refuses a capture (NCCL's collectives on some systems, or an
    autograd graph through the model kept alive from before the step,
    whose gradient accumulators then run on another stream), the reason
    is kept in ``state.graph_refused``, printed once, and this and every
    later step run eagerly."""
    device = state.model.device
    batch = batch.to(device)
    if device.type != "cuda" or state.graph_refused is not None:
        metrics = run(state, batch, loss_cfg, mesh)
        state.step += k
        return state, metrics
    key = (run.__name__,) + _shape_key(batch) + (loss_cfg, mesh)
    entry = state.graphs.get(key)
    if entry is None:
        metrics = _run_and_capture(state, key, batch, loss_cfg, mesh, run)
    else:
        graph, static, static_metrics = entry
        with timing.span("step.replay"):
            for f in dataclasses.fields(Batch):
                getattr(static, f.name).copy_(getattr(batch, f.name))
            graph.replay()
            # the next graph to replay may reuse this one's memory
            metrics = {n: t.clone() for n, t in static_metrics.items()}
            for p in state.model.parameters():
                p.grad = None  # an earlier eager step's, not this one's
        state.graph_replays += 1
    state.step += k
    return state, metrics


def _run_and_capture(state: TrainState, key: tuple, batch: Batch,
                     loss_cfg: LossConfig, mesh, run
                     ) -> dict[str, torch.Tensor]:
    """The eager run of the first batch of ``key``, then the capture of
    its graph into ``state.graphs`` (see :func:`_dispatch`); returns the
    eager run's metrics."""
    device = state.model.device
    if state.graph_stream is None:
        state.graph_stream = torch.cuda.Stream(device)
    stream = state.graph_stream
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        metrics = run(state, batch, loss_cfg, mesh)
    torch.cuda.current_stream(device).wait_stream(stream)
    static = Batch(**{f.name: torch.empty_like(getattr(batch, f.name))
                      for f in dataclasses.fields(Batch)})
    params = list(state.model.parameters())
    grads = [p.grad for p in params]
    if state.graph_pool is None:
        # One pool for all of the state's graphs, so that the shapes of a
        # bucketed configuration do not each hold a step's activations.
        # PyTorch calls a shared pool safe when graphs replay in the order
        # they were captured; here shapes come in any order. It stays
        # sound because nothing a graph allocates is read after another
        # graph has replayed: a replay writes its activations, gradients
        # and metrics before it reads them, its metrics are cloned right
        # after it (_dispatch), the gradients the capture leaves on the
        # parameters are replaced below, and what a graph reads from
        # before its replay (its static inputs, the parameters, Adam's
        # state and rate) was allocated outside the pool.
        state.graph_pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    try:
        # capture_begin / capture_end, not torch.cuda.graph: that context
        # also synchronizes and empties the device's and the pinned host
        # memory caches before each capture, which costs every shape's
        # capture and the first batches after it
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=state.graph_pool)
            try:
                static_metrics = run(state, static, loss_cfg, mesh,
                                     timed=False)
            finally:
                graph.capture_end()
    except RuntimeError as e:
        if not _capture_refused(e):
            raise
        # the failed capture never ran its epilogue, which leaves the
        # device's generator in capture mode (its next draw outside a
        # capture raises): give it a copy of its state, same seed and
        # offset, outside any capture
        gen = torch.cuda.default_generators[stream.device_index]
        gen.graphsafe_set_state(gen.clone_state())
        state.graph_refused = f"{type(e).__name__}: {e}"
        print("train_step: the card refused to capture the step "
              f"({state.graph_refused}); running every step eagerly")
    else:
        state.graphs[key] = (graph, static, static_metrics)
        timing.count("step.captures")
    finally:
        # the eager run's gradients, not the capture's (in the pool)
        for p, g in zip(params, grads):
            p.grad = g
    return metrics
