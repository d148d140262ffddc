"""Data-parallel training placement, counterpart of
``cmhse_tpu/parallel/train_dp.py``, and the collectives of the
data-parallel step (:func:`cmhse_tpu_torch.train.state.train_step` with a
``mesh``).

The JAX step computes its loss on the global arrays: the hardest negatives
and the multi-positive masks span the whole global batch, and the
reconstruction mean runs over every valid clip of it. DDP, which averages
each rank's local loss, would take each rank's negatives from its own rows
only: another objective. So the port's step

1. runs the forward on this rank's rows;
2. gathers every tensor the objective reads across the ``data`` axis, with
   autograd (:func:`gather_global`);
3. computes the same global loss on every rank, and its backward;
4. sums the gradients over the ranks as one flat buffer
   (:func:`all_reduce_gradients`);
5. clips at the global norm and takes the Adam step, identically on every
   rank.

Every rank computes the same global loss from the same gathered block, so
the cotangent of that block is the same on every rank. The gather's
backward keeps this rank's rows of it: each rank's gradient is the global
objective's gradient through its own rows, and their sum is exactly the
global objective's gradient. No collective runs in the backward, and
nothing is divided.

Every collective is synchronous (see :mod:`cmhse_tpu_torch.parallel.mesh`):
the step's stream waits on each before it enqueues a cooperative GRU grid.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.parallel.mesh import (Mesh, _all_gather_single,
                                           all_gather_rows)


def place_state(state, mesh: Mesh):
    """Make rank 0's parameters, buffers, Adam state and step count every
    rank's, by broadcast over the whole run (the ``model`` axis's replicas
    too). Fresh weights from one seed need not agree across ranks, nor
    across torch builds, and a resume reads the same files but is made
    equal here all the same. Returns ``state``."""
    mesh.check_process_mesh("place_state")
    if mesh.group is None:
        return state
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    opt = state.optimizer
    for p in (p for g in opt.param_groups for p in g["params"]):
        st = opt.state.get(p, {})
        tensors += [st[k] for k in sorted(st) if isinstance(st[k],
                                                            torch.Tensor)]
    for t in tensors:
        _broadcast_(t.data, mesh)
    step = torch.tensor([state.step], dtype=torch.int64)
    _broadcast_(step, mesh)
    state.step = int(step.item())
    return state


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Rank 0's ``t`` into ``t`` on every rank; a tensor off the group's
    device (Adam's CPU step counts, the step count) goes through it."""
    if t.device == mesh.device:
        dist.broadcast(t, src=0)
        return
    tmp = t.to(mesh.device)
    dist.broadcast(tmp, src=0)
    t.copy_(tmp)


def local_rows(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's rows of a global batch: the contiguous slice the loader
    gives it with ``process_index=mesh.data_index``,
    ``process_count=mesh.data_size``."""
    mesh.check_process_mesh("local_rows")
    rows = batch.frames.shape[0]
    if rows % mesh.data_size:
        raise ValueError(f"a batch of {rows} rows does not split over a "
                         f"data axis of {mesh.data_size}")
    n = rows // mesh.data_size
    lo = mesh.data_index * n
    return Batch(**{f.name: getattr(batch, f.name)[lo:lo + n]
                    for f in dataclasses.fields(Batch)})


def place_batch(batch: Batch, mesh: Mesh, non_blocking: bool = False
                ) -> Batch:
    """This rank's rows (the loader already sliced them) on its device."""
    mesh.check_process_mesh("place_batch")
    return batch.to(mesh.device, non_blocking=non_blocking)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over the data axis, rank-major. Backward:
    this rank's rows of the gathered block's cotangent, which every rank
    holds alike (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        # synchronous: the stream waits on it (module docstring)
        _all_gather_single(out, x.contiguous(), group=group)
        ctx.index, ctx.rows = index, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None


def gather_rows(x: torch.Tensor | None, mesh: Mesh) -> torch.Tensor | None:
    """``x`` of every rank along the data axis, with autograd for a float
    tensor; bool and int tensors travel without it (bool as uint8)."""
    if x is None or mesh.group is None:
        return x
    if x.is_floating_point():
        return _GatherRows.apply(x, mesh.group, mesh.data_size,
                                 mesh.data_index)
    return all_gather_rows(x, mesh)


def gather_global(outputs, batch: Batch, mesh: Mesh):
    """The global batch's view of what the objective reads: every field of
    the model's outputs and the batch's ``video_ids`` and ``valid``,
    gathered over the data axis. Returns ``(outputs, batch)``; the batch
    holds only those two fields."""
    mesh.check_process_mesh("the data-parallel step")
    outputs = dataclasses.replace(outputs, **{
        f.name: gather_rows(getattr(outputs, f.name), mesh)
        for f in dataclasses.fields(outputs)})
    fields = {f.name: None for f in dataclasses.fields(Batch)}
    fields["video_ids"] = gather_rows(batch.video_ids, mesh)
    fields["valid"] = gather_rows(batch.valid, mesh)
    return outputs, Batch(**fields)


def all_reduce_gradients(grads: list[torch.Tensor], mesh: Mesh) -> None:
    """Sum the gradients over the data axis as one flat buffer, in
    place."""
    mesh.check_process_mesh("all_reduce_gradients")
    if mesh.group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    # synchronous: the stream waits on it before the clip (and before the
    # next step's cooperative grids); no bucketed overlap with the backward
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
