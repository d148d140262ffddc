"""Train state and the update step, counterpart of
``cmhse_tpu/train/state.py``: forward, loss, backward, global-norm clip,
Adam.

The model's parameters are updated in place (the JAX step donates its
state and returns a new one; here the returned state is the one passed in,
its ``step`` advanced). :func:`train_steps` runs K updates over a stacked
batch, the counterpart of the JAX package's one-dispatch ``lax.scan``: on
the card, one replay of a CUDA graph of the K steps.

On the card Adam is built with ``capturable=True`` and a tensor learning
rate, so that a captured step reads its rate and its step count from the
device: :func:`set_learning_rate` then writes into that tensor and never
needs a new capture.

With a ``mesh`` (:mod:`cmhse_tpu_torch.parallel`) the step is the
data-parallel one: each rank feeds its rows of the global batch, and the
loss is the JAX package's global one (see
:mod:`cmhse_tpu_torch.parallel.train_dp`); every rank ends the step with
the same parameters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from cmhse_tpu_torch.config import ExperimentConfig, LossConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.models.cmhse import CMHSE
from cmhse_tpu_torch.parallel import train_dp
from cmhse_tpu_torch.train.objective import total_loss


@dataclass
class TrainState:
    """The model, its optimizer, the clip threshold and the step count."""

    model: CMHSE
    optimizer: torch.optim.Optimizer
    grad_clip: float
    step: int = 0
    # train_steps on the card: a CUDA graph of K steps by the stacked
    # batch's shapes, and how many times one was replayed
    graphs: dict = field(default_factory=dict, repr=False)
    graph_replays: int = 0
    # why the card refused to capture a step under a mesh (train_steps
    # then runs its steps one a dispatch); None while captures succeed
    graph_refused: str | None = None

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
        Captured graphs are dropped: they read Adam's old state tensors."""
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


def _update(state: TrainState, batch: Batch, loss_cfg: LossConfig,
            mesh=None) -> dict[str, torch.Tensor]:
    """One optimisation step on a batch on the model's device, leaving
    ``state.step`` alone (shared body of :func:`train_step` and
    :func:`train_steps`, and what a graph captures). With ``mesh``, the
    batch is this rank's rows and the loss the global batch's."""
    model = state.model
    params = list(model.parameters())
    for p in params:
        p.grad = None
    outputs = model(batch)
    if mesh is not None:
        outputs, batch = train_dp.gather_global(outputs, batch, mesh)
    loss, metrics = total_loss(outputs, batch, loss_cfg)
    loss.backward()
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
    state placed by ``parallel.place_state``)."""
    metrics = _update(state, batch.to(state.model.device), loss_cfg, mesh)
    state.step += 1
    return state, metrics


def _unstack(stacked: Batch, i: int) -> Batch:
    return Batch(**{f.name: getattr(stacked, f.name)[i]
                    for f in dataclasses.fields(Batch)})


def _steps(state: TrainState, stacked: Batch, loss_cfg: LossConfig,
           mesh=None) -> dict[str, torch.Tensor]:
    """The K updates of ``stacked`` in order, metrics stacked ``[K]``."""
    out = [_update(state, _unstack(stacked, i), loss_cfg, mesh)
           for i in range(stacked.frames.shape[0])]
    return {k: torch.stack([m[k] for m in out]) for k in out[0]}


def _capture_refused(e: RuntimeError) -> bool:
    """Whether ``e`` is CUDA's or NCCL's refusal of a stream capture (an
    operation the capture does not allow), rather than a failure of the
    step itself, such as a kernel's launch or a collective."""
    return "captur" in str(e).lower()


def train_steps(state: TrainState, stacked: Batch, loss_cfg: LossConfig,
                mesh=None) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """K optimisation steps over a stacked :class:`Batch` whose fields
    carry a leading ``[K, ...]`` axis: exactly the math and order of K
    :func:`train_step` calls. Metrics come back with a leading ``[K]``
    axis.

    On the CPU the steps run one after another. On the card they are one
    replay of a CUDA graph of the K steps, captured by the stacked batch's
    shapes: the first group of a shape runs eagerly on the capture stream
    (it sets up Adam's state, the kernels and cuBLAS's workspace for that
    stream), and is then captured; each later one is copied into the
    graph's input and replayed. Replays launch no kernel from the host, so
    they add nothing to ``cuda_lib.launches``; ``state.graph_replays``
    counts them.

    With ``mesh`` the graph holds the step's NCCL collectives too. If the
    card refuses that capture, the reason is kept in
    ``state.graph_refused``, printed once, and this and every later call
    run their steps one a dispatch."""
    device = state.model.device
    stacked = stacked.to(device)
    k = stacked.frames.shape[0]
    if device.type != "cuda" or state.graph_refused is not None:
        metrics = _steps(state, stacked, loss_cfg, mesh)
        state.step += k
        return state, metrics
    key = tuple((f.name, tuple(getattr(stacked, f.name).shape),
                 getattr(stacked, f.name).dtype)
                for f in dataclasses.fields(Batch)) + (loss_cfg, mesh)
    entry = state.graphs.get(key)
    if entry is None:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            metrics = _steps(state, stacked, loss_cfg, mesh)
        torch.cuda.current_stream(device).wait_stream(stream)
        static = Batch(**{f.name: torch.empty_like(getattr(stacked, f.name))
                          for f in dataclasses.fields(Batch)})
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                static_metrics = _steps(state, static, loss_cfg, mesh)
        except RuntimeError as e:
            if mesh is None or not _capture_refused(e):
                raise
            state.graph_refused = f"{type(e).__name__}: {e}"
            print("train_steps: the card refused to capture the step with "
                  f"its collectives ({state.graph_refused}); running one "
                  "step a dispatch under the mesh")
        else:
            state.graphs[key] = (graph, static, static_metrics)
        state.step += k
        return state, metrics
    graph, static, static_metrics = entry
    for f in dataclasses.fields(Batch):
        getattr(static, f.name).copy_(getattr(stacked, f.name))
    graph.replay()
    state.graph_replays += 1
    state.step += k
    return state, {n: t.clone() for n, t in static_metrics.items()}
