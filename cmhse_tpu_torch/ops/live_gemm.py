"""The GRU's products over its B x T row-steps, on the live row-steps only:
the hand-written CUDA kernel ``csrc/live_gemm.cu`` and its plain PyTorch
versions.

A masked GRU over a padded batch ``[B, T, .]`` multiplies by a weight at
every row-step (b, t): the input projection ``xw = x @ W_i + b_i``, its
gradient ``dX = g @ W_i^T``, and the weight gradients ``dW_i = x^T g`` (with
``db_i``, the column sums of g) and ``dW_h = h_prev^T [dr', dz', dhn]``.
Only the live row-steps, ``t < lengths[b]``, carry data: the recurrence
never reads ``xw`` past a row's length, and the backward's gradients there
are exact zeros. The two forms here take only the live row-steps:

* the row form, :func:`rows_product`: ``c[b, t] = a[b, t] @ w (+ bias)``
  for each live (b, t) (``w`` ``[K, N]``, or ``[N, K]`` with ``w_nk``);
  dead rows of ``c`` are left unwritten on the card (zeros with
  ``zero_dead``, and in the plain version);
* the reduction form, :func:`rows_reduce`: ``dw = sum over live (b, t) of
  a'[b, t]^T g[b, t]`` (and the column sums of g), where ``a'`` is ``a`` or,
  with ``shift``, the previous step's row of ``a`` (``h0``, or zeros, at
  t = 0), and ``g``'s columns may continue in a second tensor.

On a CUDA tensor each launches the kernel on the plan of the live rows that
the GRU's recurrence takes (:func:`cmhse_tpu_torch.ops.gru_kernel._live_plan`:
``(order, counts, starts)``), reads nothing back to the host and sizes
nothing by the data, so a CUDA graph may capture it; the launches count in
``cuda_lib.launches`` under ("live_gemm", "float32", "rows" or "reduce"). It
takes f32 only (bf16 keeps ``torch.matmul``, chosen by :func:`takes`). On a
CPU tensor each is its plain version, a product of the live rows gathered
by the mask. The model's CPU path keeps the dense products, the JAX
package's; :func:`takes` is where it chooses.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops import cuda_lib


def takes(x: torch.Tensor) -> bool:
    """Whether the GRU's products over ``x``'s row-steps take the live
    row-steps only: f32 on a CUDA device. bf16 keeps the dense
    ``torch.matmul`` (its tensor-core product is another design), the CPU
    the dense plain products (the JAX parity path)."""
    return x.device.type == "cuda" and x.dtype == torch.float32


def _live_mask(lengths: torch.Tensor, steps: int) -> torch.Tensor:
    """``[B, steps]``: t < lengths[b]."""
    t = torch.arange(steps, device=lengths.device)
    return t[None, :] < lengths[:, None]


def rows_product_plain(a: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None, lengths: torch.Tensor, *,
                       w_nk: bool = False) -> torch.Tensor:
    """Plain version of :func:`rows_product`: the live rows of ``a`` ``[B,
    T, K]`` gathered, multiplied by ``w`` ``[K, N]`` (``[N, K]`` with
    ``w_nk``), ``bias`` added, scattered into zeros ``[B, T, N]`` (f32)."""
    b, t, _ = a.shape
    live = _live_mask(lengths.to(a.device), t)
    wm = w.float().T if w_nk else w.float()
    rows = a[live].float() @ wm
    out = torch.zeros(b, t, wm.shape[1], dtype=torch.float32,
                      device=a.device)
    out[live] = rows if bias is None else rows + bias.float()
    return out


def rows_reduce_plain(a: torch.Tensor, g: torch.Tensor,
                      lengths: torch.Tensor, *, g_cols: int | None = None,
                      g_tail: torch.Tensor | None = None,
                      shift: bool = False, h0: torch.Tensor | None = None,
                      column_sums: bool = False):
    """Plain version of :func:`rows_reduce`: the live rows of ``a'`` and of
    ``g``'s columns gathered, ``a'^T g`` and the column sums (f32)."""
    b, t, m = a.shape
    live = _live_mask(lengths.to(a.device), t)
    if shift:
        first = (a.new_zeros(b, 1, m) if h0 is None else h0[:, None])
        a = torch.cat([first.to(a.dtype), a[:, :-1]], dim=1)
    cols = g if g_cols is None else g[..., :g_cols]
    if g_tail is not None:
        cols = torch.cat([cols, g_tail], dim=-1)
    rows_a, rows_g = a[live].float(), cols[live].float()
    return rows_a.T @ rows_g, rows_g.sum(dim=0) if column_sums else None


def _f32_operands(form: str, **named) -> list:
    """The kernel's operands, contiguous f32 on one CUDA device (None
    entries pass through); anything else raises."""
    out, devices = [], set()
    for name, x in named.items():
        if x is None:
            out.append(None)
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"the live_gemm kernel ({form}) takes float32 "
                            f"{name}, got {x.dtype}")
        devices.add(x.device)
        out.append(x.contiguous())
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the live_gemm kernel ({form}) takes tensors on "
                         f"one CUDA device, got {devices}")
    return out


def _plan_operands(plan, b: int, t: int) -> tuple:
    order, _, starts = plan
    if order.dtype != torch.int32 or tuple(order.shape) != (b,) or \
            starts.dtype != torch.int32 or tuple(starts.shape) != (t + 1,):
        raise ValueError(f"the plan of the live rows must hold int32 order "
                         f"[{b}] and starts [{t + 1}]")
    return order.contiguous(), starts.contiguous()


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def rows_product(a: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None, lengths: torch.Tensor, plan, *,
                 w_nk: bool = False, zero_dead: bool = False
                 ) -> torch.Tensor:
    """The row form: ``c [B, T, N]`` with ``c[b, t] = a[b, t] @ w (+
    bias)`` at each live row-step of ``a`` ``[B, T, K]``; ``w`` is ``[K,
    N]``, or ``[N, K]`` with ``w_nk`` (``g @ W_i^T``). On the card the dead
    rows of ``c`` are left unwritten, or zeros with ``zero_dead``; the
    plain version (a CPU tensor) writes zeros there."""
    if a.device.type == "cpu":
        return rows_product_plain(a, w, bias, lengths, w_nk=w_nk)
    b, t, k = a.shape
    n = w.shape[0] if w_nk else w.shape[1]
    if tuple(w.shape) != ((n, k) if w_nk else (k, n)) or (
            bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"a {tuple(a.shape)} does not meet w "
                         f"{tuple(w.shape)} (w_nk={w_nk}) and bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    a, w, bias = _f32_operands("rows", a=a, w=w, bias=bias)
    out = (torch.zeros if zero_dead else torch.empty)(
        b, t, n, dtype=torch.float32, device=a.device)
    if b == 0 or t == 0 or n == 0:
        return out
    order, starts = _plan_operands(plan, b, t)
    lib = cuda_lib.library()
    with torch.cuda.device(a.device):
        splits = lib.cmhse_live_rows_splits(b * t, n, k)
        if splits < 0:
            cuda_lib.check(-splits, "live_gemm rows splits")
        work = (torch.empty(splits, b * t, n, dtype=torch.float32,
                            device=a.device) if splits > 1 else None)
        err = lib.cmhse_live_rows(
            a.data_ptr(), k, w.data_ptr(), w.shape[1], int(w_nk), _ptr(bias),
            out.data_ptr(), n, _ptr(work), splits, order.data_ptr(),
            starts.data_ptr(), b, t, n, k,
            torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(err, "live_gemm rows launch")
    cuda_lib.count_launch("live_gemm", "float32", "rows")
    return out


def rows_reduce(a: torch.Tensor, g: torch.Tensor, lengths: torch.Tensor,
                plan, *, g_cols: int | None = None,
                g_tail: torch.Tensor | None = None, shift: bool = False,
                h0: torch.Tensor | None = None, column_sums: bool = False):
    """The reduction form: ``(dw [M, N], db [N] or None)``, ``dw`` the sum
    over the live row-steps of ``a'[b, t]^T g[b, t]``. ``a`` is ``[B, T,
    M]``; ``a'[b, t]`` is ``a[b, t]`` or, with ``shift``, ``a[b, t - 1]``
    and at t = 0 ``h0[b]`` (``[B, M]``; zeros when None). ``g[b, t]`` is the
    first ``g_cols`` columns of ``g`` (all by default), then ``g_tail``'s.
    ``db`` (with ``column_sums``) sums those columns over the same
    row-steps. Dead rows of ``g`` and ``g_tail`` are never read."""
    b, t, m = a.shape
    g_cols = g.shape[-1] if g_cols is None else g_cols
    n = g_cols + (0 if g_tail is None else g_tail.shape[-1])
    if a.device.type == "cpu":
        return rows_reduce_plain(a, g, lengths, g_cols=g_cols, g_tail=g_tail,
                                 shift=shift, h0=h0, column_sums=column_sums)
    if g.shape[:2] != (b, t) or g_cols > g.shape[-1] or (
            g_tail is not None and g_tail.shape[:2] != (b, t)) or (
            h0 is not None and tuple(h0.shape) != (b, m)):
        raise ValueError(f"a {tuple(a.shape)} does not meet g "
                         f"{tuple(g.shape)} (g_cols {g_cols}), g_tail "
                         f"{None if g_tail is None else tuple(g_tail.shape)}"
                         f" and h0 {None if h0 is None else tuple(h0.shape)}")
    a, g, g_tail, h0 = _f32_operands("reduce", a=a, g=g, g_tail=g_tail,
                                     h0=h0 if shift else None)
    dev = a.device
    dw = torch.empty(m, n, dtype=torch.float32, device=dev)
    db = (torch.empty(n, dtype=torch.float32, device=dev) if column_sums
          else None)
    if b == 0 or t == 0 or m == 0 or n == 0:
        dw.zero_()
        return dw, None if db is None else db.zero_()
    order, starts = _plan_operands(plan, b, t)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        splits = lib.cmhse_live_reduce_splits(m + int(column_sums), n, b * t)
        if splits < 0:
            cuda_lib.check(-splits, "live_gemm reduce splits")
        work = (torch.empty(splits, m + int(column_sums), n,
                            dtype=torch.float32, device=dev)
                if splits > 1 else None)
        err = lib.cmhse_live_reduce(
            a.data_ptr(), m, int(shift), _ptr(h0), g.data_ptr(),
            g.shape[-1], _ptr(g_tail),
            0 if g_tail is None else g_tail.shape[-1], g_cols,
            dw.data_ptr(), _ptr(db), _ptr(work), splits, order.data_ptr(),
            starts.data_ptr(), b, t, m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "live_gemm reduce launch")
    cuda_lib.count_launch("live_gemm", "float32", "reduce")
    return dw, db
