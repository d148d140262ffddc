"""The masked GRU recurrence and its backward: the hand-written CUDA kernels
``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu`` (with their streamed variants,
``csrc/gru_fwd_streamed.cu`` and ``csrc/gru_bwd_streamed.cu``), their plain
PyTorch versions, and the ``torch.autograd.Function`` that trains through
them.

``gru_fwd`` replaces ``cmhse_tpu/ops/pallas_gru.py:_gru_kernel`` (launched by
``pallas_gru_sequence``) in all three variants: the encode path's, the
gate-saving one (``save_gates``: also writes ``[r, z, n, hn]`` per step for
the backward) and the seeded one (``h0``: the carry starts at the caller's
state, the reconstruction decoder's). ``gru_bwd`` replaces
``cmhse_tpu/ops/pallas_gru_grad.py:_gru_bwd_kernel``, with and without
``h0``. Each runs in f32 or in bf16, the compute dtype of ``xw``; in bf16
the streams, ``W_h`` and ``h0`` are bf16 while the carried state (and
gradient), ``b_h`` and the bias sums stay f32, at the TPU kernels' rounding
points (see the sources). The products over the B x T row-steps, the input
projection ``x @ W_i + b_i`` and the weight gradients (``dW_h`` here,
``dW_i``/``dx`` in :func:`cmhse_tpu_torch.models.gru.gru_input_projection`),
are outside the recurrence's kernels: in f32 on the card they take the live
row-steps only (:mod:`cmhse_tpu_torch.ops.live_gemm`, on the same plan);
in bf16 and on the CPU they are dense matrix products, as the JAX package
leaves them to XLA.

What bounds them on an H100: ``gru_fwd`` is one cooperative grid, at most
one block per SM, that splits the hidden units across the blocks; each
block keeps its units' columns of ``W_h`` in shared memory for the whole
time loop, computes them each step for the rows still live from the
previous step's ``outs`` (read from L2), and meets the other blocks at one
grid barrier a step. A row that leaves the live rows has its frozen state
written into every later step at once, and the loop ends with the longest
row. Its f32 product runs in FFMA, its bf16 product on the tensor cores
(``mma.sync``); at 512 rows x 64 steps the FMAs of the live rows (f32) and
the L2 reads of their state (bf16) bound it, and at few live rows the fixed
cost of a step. ``gru_bwd`` is the same split run backwards: each block
keeps its units' rows of ``W_h`` in shared memory, writes their gate
gradients for every row, and after one grid barrier a step adds their
share of the carried gradient's product for the live rows only; the L2
reads of that operand bound it. See the sources for the full notes.

The live rows: all four kernels take one plan, ``(order, counts,
starts)``, made once a recurrence on the card and never read back to the
host. ``order`` sorts the rows by length (:func:`live_row_order`), so the
rows live at step t are the prefix ``order[0 : counts[t]]``
(:func:`live_counts`), which each kernel's product walks; ``starts``, the
live row-steps before each step, numbers them time-major for the products
over the row-steps (:mod:`cmhse_tpu_torch.ops.live_gemm`). The model's
GRUs (``MaskedGRU``, the reconstruction decoder) make the plan once a
layer and hand it to the projection and to :class:`TrainableGRU`, which
saves it for ``gru_bwd`` and ``dW_h``; :func:`gru_recurrence`,
:func:`gru_forward` and :func:`gru_backward`, called alone, make their own.
A CUDA graph that captures a call makes the plan anew from its ``lengths``
at every replay.

Every H runs on the card. The kernels' unit is 4 hidden units, so the
wrappers pad each gate block of an H that is not a multiple of 4 with zero
units and slice the results back (:func:`pad_forward_operands`,
:func:`pad_backward_operands`): exact, since a zero unit has r = z = 1/2,
n = tanh(0) = 0 and stays 0, and its zero row of ``W_h`` feeds no other
unit. Past the H at which a block's slice of ``W_h`` fits in shared memory
(:func:`fwd_max_hidden`, :func:`bwd_max_hidden`) each kernel runs its
streamed variant; its launches count under a variant ending in
``+streamed``. Each stages ``W_h`` slab by slab into shared memory beside
the product's operand (``gru_fwd``'s the state, ``gru_bwd``'s the gate
gradients), reads each live row's operand once a step for all of a block's
units, and multiplies only the rows still live, as the resident variants
do; each runs its resident variant's arithmetic in its order, so the two
agree bit for bit. Where ``W_h`` lives is all that sets the streamed
variants apart.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises. There is no fallback between the two, and a bf16 tensor
never goes through the f32 instantiation.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops import cuda_lib, live_gemm

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def gru_recurrence_plain(
    xw: torch.Tensor,
    w_h: torch.Tensor,
    b_h: torch.Tensor,
    lengths: torch.Tensor,
    h0: torch.Tensor | None = None,
    save_gates: bool = False,
):
    """Plain PyTorch version of ``gru_fwd``: a Python loop over T.

    Args:
      xw: ``[B, T, 3H]`` input projections ``x @ W_i + b_i``, gate order
        (r, z, n); its dtype is the compute dtype.
      w_h: ``[H, 3H]``; b_h: ``[3H]``.
      lengths: ``[B]`` int true lengths (0 allowed).
      h0: optional ``[B, H]`` initial state (zeros by default).
      save_gates: also return the gates.

    Returns: outputs ``[B, T, H]`` (padded steps hold the carried state) and
    final ``[B, H]``, the state at each row's true length; with
    ``save_gates`` also the gates ``[B, T, 4H]`` = ``[r, z, n, hn]`` per
    step (``hn = h @ W_hn + b_hn``), all in the compute dtype. The kernel
    leaves the gates of masked steps unwritten; this version computes them,
    and neither backward reads them.

    The carry is f32. In bf16, ``w_h`` and ``h0`` are rounded to bf16 and
    the product takes the carry rounded to bf16, as f32 products of
    bf16-valued operands (exact) with f32 accumulation; the outputs and
    gates are rounded once.
    """
    b, t, h3 = xw.shape
    hdim = h3 // 3
    dt = xw.dtype
    h = (torch.zeros(b, hdim, dtype=torch.float32, device=xw.device)
         if h0 is None else h0.to(dt).float())
    w = w_h.to(dt).float()
    lengths = lengths.to(xw.device)
    outs, gates = [], []
    for tt in range(t):
        hw = h.to(dt).float() @ w + b_h.float()
        xr, xz, xn = xw[:, tt].float().split(hdim, dim=-1)
        hr, hz, hn = hw.split(hdim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        h = torch.where((tt < lengths)[:, None], h_new, h)
        outs.append(h)
        if save_gates:
            gates.append(torch.cat([r, z, n, hn], dim=-1))
    if outs:
        outs = torch.stack(outs, dim=1).to(dt)
    else:
        outs = xw.new_zeros(b, 0, hdim)
    if not save_gates:
        return outs, h.to(dt)
    gates = (torch.stack(gates, dim=1).to(dt) if gates
             else xw.new_zeros(b, 0, 4 * hdim))
    return outs, h.to(dt), gates


def gru_backward_plain(
    gates: torch.Tensor,
    outs: torch.Tensor,
    lengths: torch.Tensor,
    w_h: torch.Tensor,
    douts: torch.Tensor | None = None,
    dfinal: torch.Tensor | None = None,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``gru_bwd``: a reversed Python loop over T.

    Args:
      gates: ``[B, T, 4H]`` from the gate-saving forward; outs: its
        ``[B, T, H]`` outputs (``h_prev`` of step t is ``outs[:, t-1]``).
      lengths: ``[B]``; w_h: ``[H, 3H]``.
      douts / dfinal: cotangents of outs ``[B, T, H]`` and final ``[B, H]``
        (None = zeros).
      h0: the forward's seeded state ``[B, H]`` (None = zeros).

    Returns ``dxw [B, T, 3H]`` (dr', dz', dn'), ``dhn [B, T, H]``, the bias
    sums ``db [4H]`` over rows and steps of (dr', dz', dn', dhn), and
    ``dh0 [B, H]``. ``douts[t]`` is added at every step, padded ones
    included; ``dfinal`` enters at t = T-1; a masked step (t >= length)
    passes the carried gradient through and emits zeros; it selects on the
    mask, so whatever the gates hold at masked steps never enters.

    The compute dtype is the gates' dtype; ``dxw``, ``dhn`` and ``dh0`` come
    back in it, ``db`` in f32. The carried gradient and the bias sums are
    f32; in bf16 ``[dr', dz', dhn]`` is rounded to bf16 before the ``W_h^T``
    product (f32 products of bf16-valued operands, f32 accumulation).
    """
    b, t, h4 = gates.shape
    hdim = h4 // 4
    dev = gates.device
    dt = gates.dtype
    dh = (torch.zeros(b, hdim, dtype=torch.float32, device=dev)
          if dfinal is None else dfinal.float())
    lengths = lengths.to(dev)
    w_ht = w_h.to(dt).float().T
    dxw = torch.zeros(b, t, 3 * hdim, dtype=torch.float32, device=dev)
    dhn_all = torch.zeros(b, t, hdim, dtype=torch.float32, device=dev)
    for tt in reversed(range(t)):
        if douts is not None:
            dh = dh + douts[:, tt].float()
        live = (tt < lengths)[:, None]
        r, z, n, hn = gates[:, tt].float().split(hdim, dim=-1)
        if tt > 0:
            hp = outs[:, tt - 1].float()
        elif h0 is not None:
            hp = h0.float()
        else:
            hp = torch.zeros_like(dh)
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dhn = dn_pre * r
        dz_pre = dz * z * (1.0 - z)
        dr_pre = dr * r * (1.0 - r)
        dr_pre, dz_pre, dn_pre, dhn = [torch.where(live, x, 0.0)
                                       for x in (dr_pre, dz_pre, dn_pre, dhn)]
        dxw[:, tt] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhn_all[:, tt] = dhn
        dhw = torch.cat([dr_pre, dz_pre, dhn], dim=-1).to(dt).float()
        dh = torch.where(live, dh * z + dhw @ w_ht, dh)
    db = torch.cat([dxw.sum(dim=(0, 1)), dhn_all.sum(dim=(0, 1))])
    return dxw.to(dt), dhn_all.to(dt), db, dh.to(dt)


def padded_hidden(hdim: int) -> int:
    """H rounded up to a multiple of 4, the unit the kernels take."""
    return -(-hdim // 4) * 4


def pad_units(x: torch.Tensor | None, hdim: int, hp: int,
              blocks: int) -> torch.Tensor | None:
    """``x`` with each of the ``blocks`` gate blocks of its last dim
    zero-padded from ``hdim`` to ``hp`` units (None passes through)."""
    if x is None or hp == hdim:
        return x
    lead = x.shape[:-1]
    x = x.reshape(*lead, blocks, hdim)
    return torch.nn.functional.pad(x, (0, hp - hdim)).reshape(
        *lead, blocks * hp)


def unpad_units(x: torch.Tensor, hdim: int, hp: int,
                blocks: int) -> torch.Tensor:
    """The inverse of :func:`pad_units`: each gate block cut back to its
    first ``hdim`` units (a contiguous copy)."""
    if hp == hdim:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, blocks, hp)[..., :hdim].reshape(
        *lead, blocks * hdim).contiguous()


def pad_w_h(w_h: torch.Tensor, hdim: int, hp: int) -> torch.Tensor:
    """``[H, 3H]`` to ``[Hp, 3Hp]``: zero rows for the padded units' state
    and zero columns in each gate block."""
    if hp == hdim:
        return w_h
    return torch.nn.functional.pad(pad_units(w_h, hdim, hp, 3),
                                   (0, 0, 0, hp - hdim))


def pad_forward_operands(xw, w_h, b_h, h0, hp: int) -> tuple:
    """``(xw, w_h, b_h, h0)`` of the forward padded to ``hp`` units."""
    hdim = xw.shape[-1] // 3
    return (pad_units(xw, hdim, hp, 3), pad_w_h(w_h, hdim, hp),
            pad_units(b_h, hdim, hp, 3), pad_units(h0, hdim, hp, 1))


def unpad_forward_results(result: tuple, hdim: int) -> tuple:
    """``(outs, final[, gates])`` of a padded forward cut back to
    ``hdim`` units."""
    hp = result[0].shape[-1]
    return tuple(unpad_units(x, hdim, hp, blocks)
                 for x, blocks in zip(result, (1, 1, 4)))


def pad_backward_operands(gates, outs, w_h, douts, dfinal, h0,
                          hp: int) -> tuple:
    """``(gates, outs, w_h, douts, dfinal, h0)`` of the backward padded
    to ``hp`` units. The padded units' gates are zeros, not the forward's
    r = z = 1/2: their gradient is zero whatever the gates hold."""
    hdim = outs.shape[-1]
    return (pad_units(gates, hdim, hp, 4), pad_units(outs, hdim, hp, 1),
            pad_w_h(w_h, hdim, hp), pad_units(douts, hdim, hp, 1),
            pad_units(dfinal, hdim, hp, 1), pad_units(h0, hdim, hp, 1))


def unpad_backward_results(result: tuple, hdim: int) -> tuple:
    """``(dxw, dhn, db, dh0)`` of a padded backward cut back to ``hdim``
    units."""
    hp = result[1].shape[-1]
    return tuple(unpad_units(x, hdim, hp, blocks)
                 for x, blocks in zip(result, (3, 1, 4, 1)))


def _check(xw, w_h, b_h, lengths, h0) -> None:
    if xw.dim() != 3 or xw.shape[-1] % 3:
        raise ValueError(f"xw must be [B, T, 3H], got {tuple(xw.shape)}")
    hdim = xw.shape[-1] // 3
    if tuple(w_h.shape) != (hdim, 3 * hdim):
        raise ValueError(f"w_h must be [{hdim}, {3 * hdim}], got "
                         f"{tuple(w_h.shape)}")
    if tuple(b_h.shape) != (3 * hdim,):
        raise ValueError(f"b_h must be [{3 * hdim}], got {tuple(b_h.shape)}")
    if tuple(lengths.shape) != (xw.shape[0],):
        raise ValueError(f"lengths must be [{xw.shape[0]}], got "
                         f"{tuple(lengths.shape)}")
    if h0 is not None and tuple(h0.shape) != (xw.shape[0], hdim):
        raise ValueError(f"h0 must be [{xw.shape[0]}, {hdim}], got "
                         f"{tuple(h0.shape)}")
    tensors = [x for x in (xw, w_h, b_h, lengths, h0) if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the GRU runs on cpu or cuda, not "
                         f"{xw.device.type}")


def _kernel_operands(kernel: str, dtype: torch.dtype, named: dict,
                     lengths: torch.Tensor) -> list[torch.Tensor | None]:
    """Check what a CUDA kernel takes (every tensor in the compute ``dtype``
    but an f32 ``b_h``, contiguous, int32 lengths) and give each tensor
    16-byte alignment (an offset view gets an aligned copy). None entries
    pass through."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the {kernel} kernel computes in float32 or "
                        f"bfloat16, not {dtype}")
    out = []
    for name, x in named.items():
        if x is None:
            out.append(None)
            continue
        want = torch.float32 if name == "b_h" else dtype
        if x.dtype != want:
            raise TypeError(f"the {kernel} kernel takes {want} {name} here, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes a contiguous {name}")
        out.append(x if x.data_ptr() % 16 == 0 else x.clone())
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"the {kernel} kernel takes contiguous int32 lengths")
    return out


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def live_row_order(lengths: torch.Tensor) -> torch.Tensor:
    """The batch rows ordered by length, longest first, equal lengths in
    row order (int32, on ``lengths``' device): the rows live at step t,
    ``t < length``, are then a prefix of it, which every GRU kernel's
    product walks."""
    return torch.argsort(lengths, descending=True, stable=True).to(
        torch.int32)


def live_counts(lengths: torch.Tensor, steps: int) -> torch.Tensor:
    """The rows live at each of ``steps`` steps, ``t < length`` (int32
    ``[steps]``, on ``lengths``' device): the length of the prefix of
    :func:`live_row_order` that step t multiplies."""
    t = torch.arange(steps, device=lengths.device)
    return (lengths[:, None] > t[None, :]).sum(0, dtype=torch.int32)


def _live_plan(x: torch.Tensor, lengths: torch.Tensor) -> tuple:
    """The kernels' plan of the live rows of ``x`` ``[B, T, ...]``:
    ``(order, counts, starts)`` made on the card (module docstring), with
    ``starts`` ``[T + 1]`` int32 the live row-steps before each step; none
    on the CPU, whose plain versions take no plan."""
    if x.device.type == "cpu":
        return ()
    counts = live_counts(lengths, x.shape[1])
    starts = torch.nn.functional.pad(
        torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    return live_row_order(lengths), counts, starts


def fwd_max_hidden(dtype: torch.dtype = torch.float32) -> int:
    """Largest H of the resident ``gru_fwd`` variant in ``dtype`` on the
    current CUDA device: each block's slice of W_h and its staging buffers
    must fit in its shared memory. A larger H takes the streamed variant.
    Builds the library."""
    return cuda_lib.library().cmhse_gru_fwd_max_hidden(
        int(dtype == torch.bfloat16))


def bwd_max_hidden(dtype: torch.dtype = torch.float32) -> int:
    """Largest H of the resident ``gru_bwd`` variant in ``dtype`` on the
    current CUDA device: each block's rows of W_h and its staging buffers
    must fit in its shared memory. A larger H takes the streamed variant.
    Builds the library."""
    return cuda_lib.library().cmhse_gru_bwd_max_hidden(
        int(dtype == torch.bfloat16))


def _bwd_streamed(hdim: int, dt: torch.dtype, dev: torch.device) -> bool:
    """Whether ``gru_bwd`` takes its streamed variant at ``hdim`` (past
    its resident limit). Raises past what either variant takes."""
    # phase 1 of gru_bwd (both variants) takes a unit a thread of one
    # 256-thread block an SM, so this refusal is the card's, not the
    # resident limit's
    most = 256 * torch.cuda.get_device_properties(dev).multi_processor_count
    if hdim > most:
        raise ValueError(f"the gru_bwd kernel takes H up to {most} on this "
                         f"card (256 units a block, one block an SM), got "
                         f"{hdim}")
    return hdim > cuda_lib.library().cmhse_gru_bwd_max_hidden(
        int(dt == torch.bfloat16))


def gru_forward(
    xw: torch.Tensor,
    w_h: torch.Tensor,
    b_h: torch.Tensor,
    lengths: torch.Tensor,
    h0: torch.Tensor | None = None,
    save_gates: bool = False,
):
    """The recurrence with no autograd: same contract as
    :func:`gru_recurrence_plain`.

    On the CPU it is the plain version. On a CUDA device it launches
    ``gru_fwd`` in the variant the arguments ask for and the instantiation
    of ``xw``'s dtype (f32 or bf16), which takes contiguous
    ``xw``/``w_h``/``h0`` in that dtype, an f32 ``b_h`` and int32
    ``lengths``; anything else raises. H not a multiple of 4 is padded
    (module docstring); H past :func:`fwd_max_hidden` takes the streamed
    variant. It makes the plan of the live rows for the call (module
    docstring). Each launch counts in ``cuda_lib.launches`` under
    ("gru_fwd", dtype, variant), the variant "encode", "with_h0",
    "save_gates" or "save_gates+with_h0", with "+streamed" appended past
    the resident limit.
    """
    _check(xw, w_h, b_h, lengths, h0)
    return _gru_forward(xw, w_h, b_h, lengths, h0, save_gates,
                        _live_plan(xw, lengths))


def _gru_forward(xw, w_h, b_h, lengths, h0, save_gates: bool, plan):
    """:func:`gru_forward` on the plan of the live rows,
    :func:`_live_plan`'s."""
    if xw.device.type == "cpu":
        return gru_recurrence_plain(xw, w_h, b_h, lengths, h0, save_gates)
    hdim = xw.shape[-1] // 3
    if padded_hidden(hdim) != hdim:
        padded = pad_forward_operands(xw, w_h, b_h, h0, padded_hidden(hdim))
        return unpad_forward_results(
            _gru_forward(padded[0], padded[1], padded[2], lengths, padded[3],
                         save_gates, plan), hdim)
    dt = xw.dtype
    xw, w_h, b_h, h0 = _kernel_operands(
        "gru_fwd", dt, {"xw": xw, "w_h": w_h, "b_h": b_h, "h0": h0}, lengths)
    b, t, _ = xw.shape
    dev = xw.device
    outs = torch.empty(b, t, hdim, dtype=dt, device=dev)
    final = torch.empty(b, hdim, dtype=dt, device=dev)
    gates = (torch.empty(b, t, 4 * hdim, dtype=dt, device=dev)
             if save_gates else None)
    result = (outs, final, gates) if save_gates else (outs, final)
    if b == 0:
        return result
    if t == 0:
        if h0 is None:
            final.zero_()
        else:
            final.copy_(h0)
        return result
    lib = cuda_lib.library()
    bf16 = int(dt == torch.bfloat16)
    with torch.cuda.device(dev):
        streamed = hdim > lib.cmhse_gru_fwd_max_hidden(bf16)
        # bf16: the f32 carry of each block's own units (the outputs are
        # rounded, so they cannot carry it)
        carry = (torch.empty(b, hdim, dtype=torch.float32, device=dev)
                 if bf16 else None)
        order, counts, _ = plan
        launch = (lib.cmhse_gru_fwd_streamed if streamed
                  else lib.cmhse_gru_fwd)
        err = launch(
            xw.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), order.data_ptr(),
            counts.data_ptr(), _ptr(h0), outs.data_ptr(), final.data_ptr(),
            _ptr(gates), _ptr(carry), b, t, hdim, bf16,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "gru_fwd launch")
    flags = [f for f, on in (("save_gates", save_gates),
                             ("with_h0", h0 is not None)) if on]
    variant = "+".join(flags) or "encode"
    cuda_lib.count_launch("gru_fwd", _dtype_name(dt),
                          variant + ("+streamed" if streamed else ""))
    return result


def gru_backward(
    gates: torch.Tensor,
    outs: torch.Tensor,
    lengths: torch.Tensor,
    w_h: torch.Tensor,
    douts: torch.Tensor | None = None,
    dfinal: torch.Tensor | None = None,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """BPTT from the saved gates: same contract as
    :func:`gru_backward_plain`.

    On the CPU it is the plain version. On a CUDA device it launches the
    ``gru_bwd`` instantiation of the gates' dtype (f32 or bf16), which takes
    contiguous tensors all in that dtype and int32 ``lengths``; anything
    else raises. H not a multiple of 4 is padded (module docstring); H past
    :func:`bwd_max_hidden` takes the streamed variant, up to 256 units a
    block on one block an SM. It makes the plan of the live rows for the
    call (module docstring). One launch a call, counted in
    ``cuda_lib.launches`` under ("gru_bwd", dtype, "with_h0" or
    "zero_h0"), with "+streamed" appended past the resident limit.
    """
    b, t, h4 = gates.shape
    hdim = h4 // 4
    for name, x, shape in (("outs", outs, (b, t, hdim)),
                           ("w_h", w_h, (hdim, 3 * hdim)),
                           ("lengths", lengths, (b,)),
                           ("douts", douts, (b, t, hdim)),
                           ("dfinal", dfinal, (b, hdim)),
                           ("h0", h0, (b, hdim))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(x.shape)}")
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_backward runs on cpu or cuda, not "
                         f"{gates.device.type}")
    return _gru_backward(gates, outs, lengths, w_h, douts, dfinal, h0,
                         _live_plan(gates, lengths))


def _gru_backward(gates, outs, lengths, w_h, douts, dfinal, h0, plan):
    """:func:`gru_backward` on the plan of the live rows,
    :func:`_live_plan`'s."""
    if gates.device.type == "cpu":
        return gru_backward_plain(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    b, t, h4 = gates.shape
    hdim = h4 // 4
    if padded_hidden(hdim) != hdim:
        padded = pad_backward_operands(gates, outs, w_h, douts, dfinal, h0,
                                       padded_hidden(hdim))
        return unpad_backward_results(
            _gru_backward(padded[0], padded[1], lengths, padded[2],
                          padded[3], padded[4], padded[5], plan), hdim)
    dt = gates.dtype
    douts = None if douts is None else douts.contiguous()
    dfinal = None if dfinal is None else dfinal.contiguous()
    gates, outs, w_h, douts, dfinal, h0 = _kernel_operands(
        "gru_bwd", dt, {"gates": gates, "outs": outs, "w_h": w_h,
                        "douts": douts, "dfinal": dfinal, "h0": h0}, lengths)
    dev = gates.device
    dxw = torch.empty(b, t, 3 * hdim, dtype=dt, device=dev)
    dhn = torch.empty(b, t, hdim, dtype=dt, device=dev)
    dh0 = torch.empty(b, hdim, dtype=dt, device=dev)
    db = torch.empty(4 * hdim, dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        if dfinal is None:
            dh0.zero_()
        else:
            dh0.copy_(dfinal)
        return dxw, dhn, db.zero_(), dh0
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        streamed = _bwd_streamed(hdim, dt, dev)
        # bf16: the f32 carried gradient (dh0 is rounded, so it cannot
        # carry it; in f32 dh0 does)
        carry = (torch.empty(b, hdim, dtype=torch.float32, device=dev)
                 if dt == torch.bfloat16 else None)
        order, counts, _ = plan
        launch = (lib.cmhse_gru_bwd_streamed if streamed
                  else lib.cmhse_gru_bwd)
        err = launch(
            gates.data_ptr(), outs.data_ptr(), _ptr(h0), _ptr(douts),
            _ptr(dfinal), lengths.data_ptr(), order.data_ptr(),
            counts.data_ptr(), w_h.data_ptr(), dxw.data_ptr(),
            dhn.data_ptr(), db.data_ptr(), dh0.data_ptr(), _ptr(carry), b, t,
            hdim, int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "gru_bwd launch")
    cuda_lib.count_launch("gru_bwd", _dtype_name(dt),
                          ("zero_h0" if h0 is None else "with_h0")
                          + ("+streamed" if streamed else ""))
    return dxw, dhn, db, dh0


class TrainableGRU(torch.autograd.Function):
    """``(xw, w_h, b_h, lengths, h0, *plan) -> (outs, final)`` with the
    gate-saving forward and the BPTT backward: the port's
    ``pallas_gru_trainable`` after the input projection. The compute dtype
    is ``xw``'s: ``w_h`` and ``h0`` are rounded to it here, so an f32
    parameter gets an f32 gradient. On the card it takes the caller's plan
    of the live rows, or makes one, and saves it beside the gates for
    ``gru_bwd`` (module docstring). The backward returns ``dxw`` in the
    compute dtype (for the projection's backward), ``dW_h = h_prev^T [dr',
    dz', dhn]`` in f32 (f32 accumulation of the compute-dtype streams,
    never rounded to bf16: in f32 on the card over the live row-steps only,
    :func:`cmhse_tpu_torch.ops.live_gemm.rows_reduce`; otherwise one dense
    matrix product), ``db_h`` from the kernel's f32 bias sums, and ``dh0``
    in the seeded variant."""

    @staticmethod
    def forward(ctx, xw, w_h, b_h, lengths, h0, *plan):
        ctx.set_materialize_grads(False)
        w_c = w_h.to(xw.dtype)
        h0_c = None if h0 is None else h0.to(xw.dtype)
        _check(xw, w_c, b_h, lengths, h0_c)
        plan = plan or _live_plan(xw, lengths)
        outs, final, gates = _gru_forward(xw, w_c, b_h, lengths, h0_c, True,
                                          plan)
        ctx.save_for_backward(gates, outs, w_c, lengths, h0_c, *plan)
        ctx.dtypes = (w_h.dtype, b_h.dtype, None if h0 is None else h0.dtype)
        return outs, final

    @staticmethod
    def backward(ctx, douts, dfinal):
        gates, outs, w_c, lengths, h0, *plan = ctx.saved_tensors
        b, t, hdim = outs.shape
        dxw, dhn, db, dh0 = _gru_backward(gates, outs, lengths, w_c, douts,
                                          dfinal, h0, plan)
        if live_gemm.takes(outs):
            dw_h, _ = live_gemm.rows_reduce(outs, dxw, lengths, plan,
                                            g_cols=2 * hdim, g_tail=dhn,
                                            shift=True, h0=h0)
        else:
            first = (h0.float() if h0 is not None else
                     outs.new_zeros(b, hdim, dtype=torch.float32))[:, None]
            h_prev = torch.cat([first, outs[:, :-1].float()], dim=1).reshape(
                b * t, hdim)
            dw_h = torch.cat(
                [h_prev.T @ dxw[..., :2 * hdim].reshape(b * t, -1).float(),
                 h_prev.T @ dhn.reshape(b * t, hdim).float()], dim=1)
        db_h = torch.cat([db[:2 * hdim], db[3 * hdim:]])
        w_dtype, b_dtype, h0_dtype = ctx.dtypes
        return (dxw, dw_h.to(w_dtype), db_h.to(b_dtype), None,
                dh0.to(h0_dtype) if ctx.needs_input_grad[4] else None,
                *[None] * (len(ctx.needs_input_grad) - 5))


def gru_recurrence(
    xw: torch.Tensor,
    w_h: torch.Tensor,
    b_h: torch.Tensor,
    lengths: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked GRU recurrence in ``xw``'s dtype: same contract as
    :func:`gru_recurrence_plain` without ``save_gates``. ``w_h`` and ``h0``
    may be f32 whatever that dtype (the parameters are); they are rounded
    to it, as ``pallas_gru_sequence`` does; ``b_h`` stays f32.

    When autograd needs a gradient of any input it runs
    :class:`TrainableGRU` (the gate-saving ``gru_fwd`` and ``gru_bwd`` on
    the card, their plain versions on the CPU); otherwise it is
    :func:`gru_forward`, the encode path's kernel. A CUDA tensor the kernels
    cannot take raises. It makes the plan of the live rows for the call.
    """
    return _gru_recurrence(xw, w_h, b_h, lengths, h0,
                           _live_plan(xw, lengths))


def _gru_recurrence(xw, w_h, b_h, lengths, h0, plan):
    """:func:`gru_recurrence` on the caller's plan of the live rows,
    :func:`_live_plan`'s."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (xw, w_h, b_h, h0)):
        return TrainableGRU.apply(xw, w_h, b_h, lengths, h0, *plan)
    w_c, h0_c = w_h.to(xw.dtype), None if h0 is None else h0.to(xw.dtype)
    _check(xw, w_c, b_h, lengths, h0_c)
    return _gru_forward(xw, w_c, b_h, lengths, h0_c, False, plan)
