"""The masked GRU recurrence and its backward: the hand-written CUDA kernels
``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``, their plain PyTorch versions,
and the ``torch.autograd.Function`` that trains through them.

``gru_fwd`` replaces ``cmhse_tpu/ops/pallas_gru.py:_gru_kernel`` (launched by
``pallas_gru_sequence``), f32, in all three variants: the encode path's, the
gate-saving one (``save_gates``: also writes ``[r, z, n, hn]`` per step for
the backward) and the seeded one (``h0``: the carry starts at the caller's
state, the reconstruction decoder's). ``gru_bwd`` replaces
``cmhse_tpu/ops/pallas_gru_grad.py:_gru_bwd_kernel``, with and without
``h0``. The input projection ``x @ W_i + b_i`` and the weight-gradient
products (``dW_h``, and ``dW_i``/``dx`` through autograd) stay plain matrix
products outside the kernels, as the JAX package leaves them to XLA.

What bounds both on an H100: one block owns 8 batch rows and all H units and
runs the time loop itself, so every block streams the whole ``W_h`` (or
``W_h^T``, H x 3H f32) through its SM each step at 8 FMAs per element; a
step costs one SM's work (~0.19 ms at H = 1024, PERF.md) and a call costs T
of them, on 64 of 132 SMs at 512 rows and 8 at 64 rows. The state (and in
the backward the carried gradient) stays on chip for the whole time loop;
splitting ``W_h`` across all SMs is the later redesign. See the sources for
the full notes.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops import cuda_lib

# kernel launches, for proof that a run went through the kernels
launches = 0  # gru_fwd, every variant
save_gates_launches = 0  # gru_fwd with save_gates (the training forward)
with_h0_launches = 0  # gru_fwd with a seeded h0 (the decoders)
bwd_launches = 0  # gru_bwd


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
        (r, z, n).
      w_h: ``[H, 3H]``; b_h: ``[3H]``.
      lengths: ``[B]`` int true lengths (0 allowed).
      h0: optional ``[B, H]`` initial state (zeros by default).
      save_gates: also return the gates.

    Returns: outputs ``[B, T, H]`` (padded steps hold the carried state) and
    final ``[B, H]``, the state at each row's true length; with
    ``save_gates`` also the gates ``[B, T, 4H]`` = ``[r, z, n, hn]`` per
    step (``hn = h @ W_hn + b_hn``). The kernel leaves the gates of masked
    steps unwritten; this version computes them, and neither backward reads
    them.
    """
    b, t, h3 = xw.shape
    hdim = h3 // 3
    h = (torch.zeros(b, hdim, dtype=torch.float32, device=xw.device)
         if h0 is None else h0.float())
    lengths = lengths.to(xw.device)
    outs, gates = [], []
    for tt in range(t):
        hw = h @ w_h.float() + b_h.float()
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
        outs = torch.stack(outs, dim=1).to(xw.dtype)
    else:
        outs = xw.new_zeros(b, 0, hdim)
    if not save_gates:
        return outs, h.to(xw.dtype)
    gates = (torch.stack(gates, dim=1) if gates
             else xw.new_zeros(b, 0, 4 * hdim, dtype=torch.float32))
    return outs, h.to(xw.dtype), gates


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
    """
    b, t, h4 = gates.shape
    hdim = h4 // 4
    dev = gates.device
    dh = (torch.zeros(b, hdim, dtype=torch.float32, device=dev)
          if dfinal is None else dfinal.float())
    lengths = lengths.to(dev)
    w_ht = w_h.float().T
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
        dhw = torch.cat([dr_pre, dz_pre, dhn], dim=-1)
        dh = torch.where(live, dh * z + dhw @ w_ht, dh)
    db = torch.cat([dxw.sum(dim=(0, 1)), dhn_all.sum(dim=(0, 1))])
    return dxw, dhn_all, db, dh


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


def _kernel_operands(kernel: str, named: dict, lengths: torch.Tensor
                     ) -> list[torch.Tensor | None]:
    """Check what a CUDA kernel takes (f32, contiguous, int32 lengths) and
    give each tensor 16-byte alignment (an offset view gets an aligned
    copy). None entries pass through."""
    out = []
    for name, x in named.items():
        if x is None:
            out.append(None)
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"the {kernel} kernel takes float32 {name}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes a contiguous {name}")
        out.append(x if x.data_ptr() % 16 == 0 else x.clone())
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"the {kernel} kernel takes contiguous int32 lengths")
    return out


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def bwd_max_hidden() -> int:
    """Largest H the ``gru_bwd`` kernel takes (its shared memory); builds
    the library."""
    return cuda_lib.library().cmhse_gru_bwd_max_hidden()


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
    ``gru_fwd`` in the variant the arguments ask for, which takes f32
    contiguous ``xw``/``w_h``/``b_h``/``h0``, int32 ``lengths`` and H a
    multiple of 4; anything else raises.
    """
    global launches, save_gates_launches, with_h0_launches
    _check(xw, w_h, b_h, lengths, h0)
    if xw.device.type == "cpu":
        return gru_recurrence_plain(xw, w_h, b_h, lengths, h0, save_gates)
    xw, w_h, b_h, h0 = _kernel_operands(
        "gru_fwd", {"xw": xw, "w_h": w_h, "b_h": b_h, "h0": h0}, lengths)
    b, t, h3 = xw.shape
    hdim = h3 // 3
    if hdim % 4:
        raise ValueError(f"the gru_fwd kernel takes H a multiple of 4, got "
                         f"{hdim}")
    dev = xw.device
    outs = torch.empty(b, t, hdim, dtype=torch.float32, device=dev)
    final = torch.empty(b, hdim, dtype=torch.float32, device=dev)
    gates = (torch.empty(b, t, 4 * hdim, dtype=torch.float32, device=dev)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cmhse_gru_fwd(
            xw.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), lengths.data_ptr(),
            _ptr(h0), outs.data_ptr(), final.data_ptr(), _ptr(gates), b, t,
            hdim, stream)
    cuda_lib.check(err, "gru_fwd launch")
    launches += 1
    save_gates_launches += int(save_gates)
    with_h0_launches += int(h0 is not None)
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

    On the CPU it is the plain version. On a CUDA device it launches
    ``gru_bwd``, which takes f32 contiguous tensors, int32 ``lengths`` and H
    a multiple of 4 up to :func:`bwd_max_hidden`; anything else raises.
    """
    global bwd_launches
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
    if gates.device.type == "cpu":
        return gru_backward_plain(gates, outs, lengths, w_h, douts, dfinal,
                                  h0)
    if gates.device.type != "cuda":
        raise ValueError(f"gru_backward runs on cpu or cuda, not "
                         f"{gates.device.type}")
    douts = None if douts is None else douts.contiguous()
    dfinal = None if dfinal is None else dfinal.contiguous()
    gates, outs, w_h, douts, dfinal, h0 = _kernel_operands(
        "gru_bwd", {"gates": gates, "outs": outs, "w_h": w_h, "douts": douts,
                    "dfinal": dfinal, "h0": h0}, lengths)
    if hdim % 4:
        raise ValueError(f"the gru_bwd kernel takes H a multiple of 4, got "
                         f"{hdim}")
    lib = cuda_lib.library()
    if hdim > lib.cmhse_gru_bwd_max_hidden():
        raise ValueError(f"the gru_bwd kernel takes H up to "
                         f"{lib.cmhse_gru_bwd_max_hidden()}, got {hdim}")
    dev = gates.device
    dxw = torch.empty(b, t, 3 * hdim, dtype=torch.float32, device=dev)
    dhn = torch.empty(b, t, hdim, dtype=torch.float32, device=dev)
    dh0 = torch.empty(b, hdim, dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        if dfinal is None:
            dh0.zero_()
        else:
            dh0.copy_(dfinal)
        return dxw, dhn, torch.zeros(4 * hdim, device=dev), dh0
    n_blocks = -(-b // lib.cmhse_gru_bwd_rows_per_block())
    db_part = torch.empty(n_blocks, 4 * hdim, dtype=torch.float32,
                          device=dev)
    w_ht = w_h.t().contiguous()  # [3H, H]: row-by-row coalesced reads
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cmhse_gru_bwd(
            gates.data_ptr(), outs.data_ptr(), _ptr(h0), _ptr(douts),
            _ptr(dfinal), lengths.data_ptr(), w_ht.data_ptr(),
            dxw.data_ptr(), dhn.data_ptr(), db_part.data_ptr(),
            dh0.data_ptr(), b, t, hdim, stream)
    cuda_lib.check(err, "gru_bwd launch")
    bwd_launches += 1
    return dxw, dhn, db_part.sum(dim=0), dh0


class TrainableGRU(torch.autograd.Function):
    """``(xw, w_h, b_h, lengths, h0) -> (outs, final)`` with the
    gate-saving forward and the BPTT backward: the port's
    ``pallas_gru_trainable``. The backward returns ``dxw`` (autograd carries
    it back through ``x @ W_i + b_i`` to ``x``, ``W_i`` and ``b_i``),
    ``dW_h = h_prev^T [dr', dz', dhn]`` as one matrix product, ``db_h`` from
    the kernel's bias sums, and ``dh0`` in the seeded variant."""

    @staticmethod
    def forward(ctx, xw, w_h, b_h, lengths, h0):
        ctx.set_materialize_grads(False)
        if xw.device.type == "cuda" and xw.shape[-1] // 3 > bwd_max_hidden():
            raise ValueError(f"the gru_bwd kernel takes H up to "
                             f"{bwd_max_hidden()}, got {xw.shape[-1] // 3}")
        outs, final, gates = gru_forward(xw, w_h, b_h, lengths, h0,
                                         save_gates=True)
        ctx.save_for_backward(gates, outs, w_h, lengths, h0)
        return outs, final

    @staticmethod
    def backward(ctx, douts, dfinal):
        gates, outs, w_h, lengths, h0 = ctx.saved_tensors
        b, t, hdim = outs.shape
        dxw, dhn, db, dh0 = gru_backward(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
        first = (h0.float() if h0 is not None
                 else outs.new_zeros(b, hdim))[:, None]
        h_prev = torch.cat([first, outs[:, :-1]], dim=1).reshape(b * t, hdim)
        dw_h = torch.cat([h_prev.T @ dxw[..., :2 * hdim].reshape(b * t, -1),
                          h_prev.T @ dhn.reshape(b * t, hdim)], dim=1)
        db_h = torch.cat([db[:2 * hdim], db[3 * hdim:]])
        return (dxw, dw_h, db_h, None,
                dh0 if ctx.needs_input_grad[4] else None)


def gru_recurrence(
    xw: torch.Tensor,
    w_h: torch.Tensor,
    b_h: torch.Tensor,
    lengths: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked GRU recurrence: same contract as :func:`gru_recurrence_plain`
    without ``save_gates``.

    When autograd needs a gradient of any input it runs
    :class:`TrainableGRU` (the gate-saving ``gru_fwd`` and ``gru_bwd`` on
    the card, their plain versions on the CPU); otherwise it is
    :func:`gru_forward`, the encode path's kernel. A CUDA tensor the kernels
    cannot take raises.
    """
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (xw, w_h, b_h, h0)):
        return TrainableGRU.apply(xw, w_h, b_h, lengths, h0)
    return gru_forward(xw, w_h, b_h, lengths, h0)
