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
package's; :func:`takes` is where it chooses. :class:`LiveProduct` is the
autograd Function over both forms that the GRU's input projection and the
text tower's token products share.

The grouped forms multiply each group of rows by its own weight: the routed
experts of a mixture-of-experts layer, whose rows are the assignments of
tokens to the experts held here, sorted by expert (:func:`moe_plan`, made on
the device with no host read). :func:`moe_rows` is the row form
(``c[c_idx[s]] = scale[s] * a[a_idx[s]] @ w[e]`` for each slot s of group
e), :func:`moe_reduce` the reduction form (``dw[e] = sum over the slots s of
group e of a[a_idx[s]]^T g[g_idx[s]]``). On a CUDA tensor they launch the
``moe_*`` kernels of ``csrc/live_gemm.cu``, whose grids are fixed by the
shapes and whose tiles past the groups' device-side ends do nothing, so a
CUDA graph captures them; launches count under ("live_gemm", "float32",
"moe_rows" or "moe_reduce"). On a CPU tensor each is its plain version, a
loop over the groups.
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


class LiveProduct(torch.autograd.Function):
    """``x @ w + b`` in ``x``'s dtype, with f32 accumulation and f32
    gradients of the parameters: the GRU's input projection (``w`` its
    ``w_i [D, 3H]``) and the text tower's token products (``w`` ``[K, N]``,
    no ``b``). In bf16 autograd of the casts would round ``dW`` to bf16
    before it reaches the f32 parameter, a rounding the JAX package's custom
    VJP does not make (``pallas_gru_grad.py:335-341``). With ``lengths``
    (and the plan of the live rows) every product takes the live row-steps
    only: the forward and ``dX`` in the row form, ``dW`` with ``db`` in one
    reduction; the forward's dead rows are left unwritten, or zeros with
    ``zero_dead``, and ``dX``'s are zeros. Without ``lengths`` the products
    are dense."""

    @staticmethod
    def forward(ctx, x, w, b, lengths, zero_dead, *plan):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc, lengths, *plan)
        ctx.dtypes = (w.dtype, None if b is None else b.dtype)
        if lengths is not None:
            return rows_product(x, wc, b, lengths, plan, zero_dead=zero_dead)
        y = x.float() @ wc.float()
        return (y if b is None else y + b.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, lengths, *plan = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if lengths is not None:
            g = g.contiguous()
            if need_x:
                dx = rows_product(g, w, None, lengths, plan, w_nk=True,
                                  zero_dead=True)
            if need_w or need_b:
                # db from the same reduction whenever there is a bias
                dw, db = rows_reduce(x, g, lengths, plan,
                                     column_sums=ctx.dtypes[1] is not None)
            return (dx, dw if need_w else None, db if need_b else None,
                    *[None] * (2 + len(plan)))
        g = g.float().reshape(-1, g.shape[-1])
        if need_x:
            dx = (g @ w.float().T).to(x.dtype).reshape(x.shape)
        if need_w:
            dw = (x.float().reshape(-1, x.shape[-1]).T @ g).to(ctx.dtypes[0])
        if need_b:
            db = g.sum(dim=0).to(ctx.dtypes[1])
        return dx, dw, db, None, None


def live_product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 lengths: torch.Tensor, plan, *,
                 zero_dead: bool = False) -> torch.Tensor:
    """:class:`LiveProduct` of ``x [B, T, K]``: on the live row-steps of the
    plan where :func:`takes` ``x``, else dense over every row-step."""
    if takes(x):
        return LiveProduct.apply(x, w, b, lengths, zero_dead, *plan)
    return LiveProduct.apply(x, w, b, None, False)


# -- the grouped forms: routed experts ---------------------------------------


def moe_plan(top_i: torch.Tensor, live: torch.Tensor, held: int,
             offset: int) -> tuple:
    """The routing plan of a mixture-of-experts layer, made on ``top_i``'s
    device with no host read: ``top_i`` ``[R, k]`` the experts each row
    chose, ``live`` ``[R]`` its live rows, the experts ``offset .. offset +
    held - 1`` held here. The ``R * k`` assignments (row-major, assignment
    ``r * k + j``) are sorted by held expert, stably; dead rows' and
    assignments to experts not held go to a sentinel group past the end.
    Returns ``(tok, assign, gstarts, valid)``: slot -> row ``[R * k]`` and
    slot -> assignment ``[R * k]`` (int32), ``gstarts`` ``[held + 1]``
    int32 the slots before each expert (``gstarts[held]`` the assignments
    to held experts), ``valid`` ``[R * k]`` the slots below it."""
    r, k = top_i.shape
    dev = top_i.device
    cap = r * k
    e = top_i.long() - offset
    key = torch.where((e >= 0) & (e < held) & live.reshape(-1, 1), e,
                      held).reshape(-1)
    groups = torch.arange(held + 1, device=dev)
    # a stable counting sort: each assignment's rank within its group from
    # a running count over the assignments, with no host read; the count
    # runs along each group's row (a scan over the outer dimension of
    # [R * k, groups] is far slower on the card)
    running = (groups[:, None] == key[None, :]).to(torch.int32).cumsum(
        1, dtype=torch.int32)
    counts = (running[:, -1] if cap else
              torch.zeros(held + 1, dtype=torch.int32, device=dev))
    before = torch.nn.functional.pad(counts.cumsum(0, dtype=torch.int32),
                                     (1, 0))
    rank = running.gather(0, key[None, :])[0] - 1
    pos = before[key] + rank
    assign = torch.empty(cap, dtype=torch.int32, device=dev).scatter_(
        0, pos.long(), torch.arange(cap, dtype=torch.int32, device=dev))
    tok = torch.div(assign, k, rounding_mode="floor")
    gstarts = before[:held + 1].contiguous()
    valid = torch.arange(cap, device=dev) < gstarts[held]
    return tok, assign, gstarts, valid


def _groups(gstarts: torch.Tensor) -> list:
    """(group, first slot, end) of each non-empty group, read on the host
    (the plain versions only)."""
    s = gstarts.tolist()
    return [(e, s[e], s[e + 1]) for e in range(len(s) - 1) if s[e + 1] > s[e]]


def _index(idx: torch.Tensor | None, lo: int, hi: int, dev) -> torch.Tensor:
    if idx is None:
        return torch.arange(lo, hi, device=dev)
    return idx[lo:hi].long()


def moe_rows_plain(a: torch.Tensor, w: torch.Tensor, gstarts: torch.Tensor,
                   out: torch.Tensor, *, a_idx=None, c_idx=None, scale=None,
                   w_nk: bool = False) -> torch.Tensor:
    """Plain version of :func:`moe_rows`, a loop over the groups: writes
    ``out`` in place and returns it."""
    for e, lo, hi in _groups(gstarts):
        we = w[e].float()
        rows = a[_index(a_idx, lo, hi, a.device)].float() @ (
            we.T if w_nk else we)
        if scale is not None:
            rows = rows * scale[lo:hi, None].float()
        out[_index(c_idx, lo, hi, a.device)] = rows
    return out


def moe_reduce_plain(a: torch.Tensor, g: torch.Tensor, gstarts: torch.Tensor,
                     *, a_idx=None, g_idx=None) -> torch.Tensor:
    """Plain version of :func:`moe_reduce`, a loop over the groups."""
    groups = gstarts.shape[0] - 1
    dw = torch.zeros(groups, a.shape[-1], g.shape[-1], dtype=torch.float32,
                     device=a.device)
    for e, lo, hi in _groups(gstarts):
        dw[e] = (a[_index(a_idx, lo, hi, a.device)].float().T
                 @ g[_index(g_idx, lo, hi, a.device)].float())
    return dw


def _int32_operand(name: str, x: torch.Tensor | None, dev):
    if x is None:
        return None
    if x.dtype != torch.int32 or x.device != dev or x.dim() != 1:
        raise ValueError(f"the moe kernels take {name} as an int32 vector on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def moe_rows(a: torch.Tensor, w: torch.Tensor, gstarts: torch.Tensor,
             out: torch.Tensor, *, a_idx: torch.Tensor | None = None,
             c_idx: torch.Tensor | None = None,
             scale: torch.Tensor | None = None,
             w_nk: bool = False) -> torch.Tensor:
    """The grouped row form: for each slot s of group e (``gstarts[e] <= s <
    gstarts[e + 1]``), ``out[c_idx[s]] = scale[s] * (a[a_idx[s]] @ w[e])``,
    ``w`` ``[G, K, N]``, or ``[G, N, K]`` with ``w_nk``; an index or the
    scale left None is the slot itself, or 1. ``a`` ``[., K]`` and ``out``
    ``[., N]`` are f32 rows; rows of ``out`` no slot names are left as they
    are. Returns ``out``."""
    if a.device.type == "cpu":
        return moe_rows_plain(a, w, gstarts, out, a_idx=a_idx, c_idx=c_idx,
                              scale=scale, w_nk=w_nk)
    groups = w.shape[0]
    n, k = (w.shape[1], w.shape[2]) if w_nk else (w.shape[2], w.shape[1])
    if a.dim() != 2 or a.shape[1] != k or out.dim() != 2 or \
            out.shape[1] != n or tuple(gstarts.shape) != (groups + 1,):
        raise ValueError(f"a {tuple(a.shape)}, w {tuple(w.shape)} (w_nk="
                         f"{w_nk}), out {tuple(out.shape)} and gstarts "
                         f"{tuple(gstarts.shape)} do not meet")
    if not out.is_contiguous() or out.dtype != torch.float32:
        raise ValueError("moe_rows writes a contiguous float32 out")
    a, w, scale = _f32_operands("moe_rows", a=a, w=w, scale=scale)
    dev = a.device
    a_idx, c_idx, gstarts = (_int32_operand(nm, x, dev) for nm, x in (
        ("a_idx", a_idx), ("c_idx", c_idx), ("gstarts", gstarts)))
    slots = (a_idx if a_idx is not None else c_idx if c_idx is not None
             else a).shape[0]
    if slots == 0 or n == 0:
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        err = lib.cmhse_moe_rows(
            a.data_ptr(), a.shape[1], _ptr(a_idx), w.data_ptr(), w.shape[2],
            w.shape[1] * w.shape[2], int(w_nk), _ptr(scale), out.data_ptr(),
            n, _ptr(c_idx), gstarts.data_ptr(), groups, slots, n, k,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "live_gemm moe_rows launch")
    cuda_lib.count_launch("live_gemm", "float32", "moe_rows")
    return out


def moe_reduce(a: torch.Tensor, g: torch.Tensor, gstarts: torch.Tensor, *,
               a_idx: torch.Tensor | None = None,
               g_idx: torch.Tensor | None = None) -> torch.Tensor:
    """The grouped reduction form: ``dw`` ``[G, M, N]``, ``dw[e]`` the sum
    over the slots s of group e of ``a[a_idx[s]]^T g[g_idx[s]]`` (``a``
    ``[., M]``, ``g`` ``[., N]``; an index left None is the slot itself).
    A group with no slot gets zeros."""
    if a.device.type == "cpu":
        return moe_reduce_plain(a, g, gstarts, a_idx=a_idx, g_idx=g_idx)
    groups = gstarts.shape[0] - 1
    if a.dim() != 2 or g.dim() != 2 or groups < 1:
        raise ValueError(f"a {tuple(a.shape)}, g {tuple(g.shape)} and "
                         f"gstarts {tuple(gstarts.shape)} do not meet")
    a, g = _f32_operands("moe_reduce", a=a, g=g)
    dev = a.device
    a_idx, g_idx, gstarts = (_int32_operand(nm, x, dev) for nm, x in (
        ("a_idx", a_idx), ("g_idx", g_idx), ("gstarts", gstarts)))
    m, n = a.shape[1], g.shape[1]
    dw = torch.empty(groups, m, n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return dw
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        err = lib.cmhse_moe_reduce(
            a.data_ptr(), m, _ptr(a_idx), g.data_ptr(), n, _ptr(g_idx),
            dw.data_ptr(), gstarts.data_ptr(), groups, m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "live_gemm moe_reduce launch")
    cuda_lib.count_launch("live_gemm", "float32", "moe_reduce")
    return dw
