"""xLSTM blocks, xlstm-1.3b (port of `repro.models.xlstm`): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, true sequential
recurrence with hidden-to-hidden weights).

The mLSTM cell
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)
is the same gated linear recurrence as SSD with decoupled gates, so prefill
reuses `ssm._ssd_chunked` with k->B, q->C, v->x, i-gate->scale, log
f-gate->decay; the normalizer n is an extra all-ones channel appended to v.
`repro` vmaps `_ssd_chunked` over heads; here the heads fold into the batch
axis. Decode is the O(1) recurrent update. sLSTM is sequential by
construction: a Python loop over time with stabilized exponential gating,
run as one operator (``repro_torch::slstm_scan``) whose backward recomputes
the loop and walks it back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.dtensor import batch_local, keep_only

from .layers import _dense_init, _normal, einsum, init_rmsnorm, mm, \
    rmsnorm_apply, split_heads
from .ssm import _causal_conv, _pad_seq, _ssd_chunked

_GATE_CLAMP = 12.0  # stabilizes exp input gates within chunks


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm(generator, d_model: int, xl, dtype, *, device=None) -> dict:
    d_inner = int(xl.proj_factor * d_model)

    def dense(shape):
        return _dense_init(generator, shape, dtype, device=device)

    return {
        "w_up": dense((d_model, 2 * d_inner)),
        "conv_w": _normal(generator, (xl.conv_width, d_inner), device, 0.1,
                          dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wq": dense((d_inner, d_inner)),
        "wk": dense((d_inner, d_inner)),
        "wv": dense((d_inner, d_inner)),
        "w_gates": dense((d_inner, 2)),  # [i, f] per token
        "gate_bias": torch.tensor([0.0, 3.0], dtype=torch.float32,
                                  device=device),  # f-bias > 0
        "out_norm": init_rmsnorm(d_inner, dtype, device=device),
        "w_down": dense((d_inner, d_model)),
    }


def mlstm_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    n_heads: int,
    chunk: int,
    state: Optional[dict] = None,  # {"conv": (B,K-1,C), "mem": (B,H,P,P+1)}
):
    Bsz, S, D = x.shape
    f32 = torch.float32
    up = mm(x, p["w_up"])
    x_in, z = torch.chunk(up, 2, dim=-1)
    d_inner = x_in.shape[-1]
    H = n_heads
    P = d_inner // H

    conv_state = state["conv"] if state is not None else None
    cx, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_state)

    q = split_heads(mm(cx, p["wq"]), H, P)
    k = split_heads(mm(cx, p["wk"]), H, P) * (P**-0.5)
    v = split_heads(mm(x_in, p["wv"]), H, P)
    gates = mm(cx, p["w_gates"]).to(f32) + p["gate_bias"]
    ig = torch.exp(torch.clamp(gates[..., 0], -_GATE_CLAMP, _GATE_CLAMP))
    logf = F.logsigmoid(gates[..., 1])  # (B,S) <= 0
    ig = ig[..., None].expand(Bsz, S, H)
    logf = logf[..., None].expand(Bsz, S, H)

    # append the all-ones normalizer channel to v
    v_aug = torch.cat(
        [v, torch.ones((Bsz, S, H, 1), dtype=v.dtype, device=v.device)], -1)

    if state is None:
        L = min(chunk, S)
        pad = (-S) % L

        def per_head(t):  # (B, S, H, ...) -> (B*H, S+pad, ...)
            # heads merge into the batch: on a process mesh only the batch
            # stays sharded
            t = keep_only(t, (0,)).movedim(2, 1)
            t = t.reshape((Bsz * H,) + t.shape[2:])
            return _pad_seq(t, after=pad) if pad else t

        # per-head k/q streams: _ssd_chunked takes shared (B,S,N) B/C, so
        # heads fold into the batch with one ssd head each (N = P)
        y_aug, mem = _ssd_chunked(
            per_head(v_aug)[:, :, None, :], per_head(ig)[:, :, None],
            per_head(logf)[:, :, None], per_head(k), per_head(q), L,
        )  # y_aug: (B*H, S+pad, 1, P+1); mem: (B*H, 1, P, P+1)
        # the heads split back out of the batch, sharded as the batch was
        # (so the gradients' merge back is too)
        y_aug = keep_only(y_aug[:, :S, 0].reshape(Bsz, H, S, P + 1),
                          (0,)).movedim(1, 2)
        mem = keep_only(mem[:, 0].reshape(Bsz, H, P, P + 1), (0,))
    else:
        m = state["mem"].to(f32)
        ys = []
        for t in range(S):
            kt, qt = k[:, t].to(f32), q[:, t].to(f32)
            m = m * torch.exp(logf[:, t])[:, :, None, None] + einsum(
                "bhp,bhn->bhpn", kt, v_aug[:, t].to(f32)
            ) * ig[:, t][:, :, None, None]
            ys.append(einsum("bhp,bhpn->bhn", qt, m))
        mem = m
        y_aug = torch.stack(ys, dim=1)

    y, n = y_aug[..., :P], y_aug[..., P]
    y = y / torch.clamp(torch.abs(n), min=1.0)[..., None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rmsnorm_apply(p["out_norm"], y) * F.silu(z)
    return mm(y, p["w_down"]), {"conv": new_conv, "mem": mem}


def mlstm_init_state(Bsz: int, d_model: int, n_heads: int, xl, dtype, *,
                     device=None) -> dict:
    d_inner = int(xl.proj_factor * d_model)
    P = d_inner // n_heads
    return {
        "conv": torch.zeros((Bsz, xl.conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "mem": torch.zeros((Bsz, n_heads, P, P + 1), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def init_slstm(generator, d_model: int, n_heads: int, xl, dtype, *,
               device=None) -> dict:
    P = d_model // n_heads

    def dense(shape):
        return _dense_init(generator, shape, dtype, device=device)

    return {
        "w_gates": dense((d_model, 4 * d_model)),  # i,f,z,o
        "r_gates": _normal(generator, (4, n_heads, P, P), device, P**-0.5,
                           dtype),
        "b_gates": torch.zeros((4, d_model), dtype=torch.float32,
                               device=device),
        "out_norm": init_rmsnorm(d_model, dtype, device=device),
        "w_up": dense((d_model, 2 * d_model)),
        "w_down": dense((d_model, d_model)),
    }


def _slstm_cell(pre, c, n, m):
    """One sLSTM step from its pre-activations `pre` (B, 4, H, P) and the
    state c, n, m (B, H, P): the new h, c, n, m."""
    it, ft, zt, ot = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    # first step: m = -inf -> f_p = 0
    f_p = torch.where(torch.isinf(m), torch.zeros_like(f_p), f_p)
    c = f_p * c + i_p * torch.tanh(zt)
    n = f_p * n + i_p
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return h, c, n, m_new


def _slstm_pre(wx_t, r, b, h):
    """A step's pre-activations: its input projection, the recurrent
    product of the last h and the bias."""
    rec = einsum("ghpq,bhq->bghp", r, h)  # (B,4,H,P)
    return wx_t.to(torch.float32) + rec + b


def _slstm_steps(wx, r, b, h, c, n, m):
    """The sLSTM recurrence over the sequence on plain tensors: wx (B, S,
    4, H, P), r (4, H, P, P) and b (4, H, P) in float32, the state (B, H,
    P). Returns every step's h stacked (B, S, H, P) and the last h, c, n,
    m."""
    hs = []
    for t in range(wx.shape[1]):
        h, c, n, m = _slstm_cell(_slstm_pre(wx[:, t], r, b, h), c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1), h, c, n, m


def _slstm_cell_grad(pre, c, n, m, gh, gc, gn, gm):
    """The backward of `_slstm_cell` at (pre, c, n, m), given the gradients
    of its outputs h, c, n, m: the gradients of pre, c, n, m, as autograd
    gives them (``maximum`` splits a tie in halves, ``clamp`` passes where
    n >= 1, nothing flows through the first step's f_p)."""
    it, ft, zt, ot = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    log_f = F.logsigmoid(ft)
    a = log_f + m
    m_new = torch.maximum(a, it)
    i_p = torch.exp(it - m_new)
    f_raw = torch.exp(a - m_new)
    first = torch.isinf(m)
    f_p = torch.where(first, torch.zeros_like(f_raw), f_raw)
    tz = torch.tanh(zt)
    c_new = f_p * c + i_p * tz
    n_new = f_p * n + i_p
    so = torch.sigmoid(ot)
    nc = torch.clamp(n_new, min=1.0)
    # h = (so * c_new) / nc
    g_sc = gh / nc
    gn = gn + torch.where(n_new >= 1.0, -gh * (so * c_new) / (nc * nc),
                          torch.zeros_like(gh))
    gc = gc + g_sc * so
    g_o = g_sc * c_new * so * (1 - so)
    # c_new = f_p * c + i_p * tz, n_new = f_p * n + i_p
    g_fp = torch.where(first, torch.zeros_like(gc), gc * c + gn * n)
    g_ip = gc * tz + gn
    g_z = gc * i_p * (1 - tz * tz)
    gc_prev, gn_prev = gc * f_p, gn * f_p
    # f_raw = exp(a - m_new), i_p = exp(it - m_new), m_new = max(a, it)
    g_fa = g_fp * f_raw
    g_ii = g_ip * i_p
    g_m = gm - g_fa - g_ii
    split = torch.where(a == it, g_m / 2, g_m)
    zero = torch.zeros_like(g_m)
    g_a = g_fa + torch.where(a < it, zero, split)
    g_i = g_ii + torch.where(a > it, zero, split)
    g_f = g_a * torch.sigmoid(-ft)
    return torch.stack([g_i, g_f, g_z, g_o], dim=1), gc_prev, gn_prev, g_a


def _slstm_grads(wx, r, b, h, c, n, m, g_hs, g_h, g_c, g_n, g_m):
    """The gradients of `_slstm_steps`' inputs given those of its outputs,
    the backward recurrence written out: the forward is run again keeping
    each step's pre-activations and state, then walked back. Per step, one
    recurrent product forward and two backward (r's and h's gradients)."""
    saved = []
    for t in range(wx.shape[1]):
        pre = _slstm_pre(wx[:, t], r, b, h)
        saved.append((pre, h, c, n, m))
        h, c, n, m = _slstm_cell(pre, c, n, m)
    g_wx = torch.empty_like(wx)
    g_r = torch.zeros_like(r)
    g_b = torch.zeros(b.shape, device=b.device,
                      dtype=torch.promote_types(b.dtype, torch.float32))
    gh, gc, gn, gm = g_h, g_c, g_n, g_m
    for t in reversed(range(wx.shape[1])):
        pre, h, c, n, m = saved.pop()
        g_pre, gc, gn, gm = _slstm_cell_grad(pre, c, n, m, gh + g_hs[:, t],
                                             gc, gn, gm)
        g_wx[:, t] = g_pre
        g_b += g_pre.sum(0)
        g_r += einsum("bghp,bhq->ghpq", g_pre, h)
        gh = einsum("bghp,ghpq->bhq", g_pre, r)
    return g_wx, g_r, g_b.to(b.dtype), gh, gc, gn, gm


_SLSTM_OPS: dict = {}


def _slstm_scan_op():
    """``repro_torch::slstm_scan``: `_slstm_steps` as one operator
    (registered on first use). Its backward, ``slstm_scan_grad``, is
    `_slstm_grads`: the recurrence run again from the saved inputs and
    walked back by hand (no autograd inside an operator), holding only the
    inputs between the passes. Each has a fake implementation (shapes
    only) and a FLOP formula (the recurrent product, 2·B·4H·P² a step;
    three of them a step backward: the recompute and the two gradient
    products), so a dry-run on fake tensors counts the recurrence without
    running it a step at a time."""
    if _SLSTM_OPS:
        return _SLSTM_OPS["fwd"]
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    state = "Tensor h, Tensor c, Tensor n, Tensor m"

    @custom_op("repro_torch::slstm_scan", mutates_args=(),
               schema=f"(Tensor wx, Tensor r, Tensor b, {state}) -> "
                      f"(Tensor, Tensor, Tensor, Tensor, Tensor)")
    def fwd(wx, r, b, h, c, n, m):
        with torch.no_grad():
            return _slstm_steps(wx, r, b, h, c, n, m)

    @fwd.register_fake
    def _(wx, r, b, h, c, n, m):
        B, S, _, H, P = wx.shape
        return (wx.new_empty((B, S, H, P), dtype=torch.float32),
                *(t.new_empty(t.shape) for t in (h, c, n, m)))

    @custom_op("repro_torch::slstm_scan_grad", mutates_args=(),
               schema=f"(Tensor wx, Tensor r, Tensor b, {state}, "
                      f"Tensor g_hs, Tensor g_h, Tensor g_c, Tensor g_n, "
                      f"Tensor g_m) -> (Tensor, Tensor, Tensor, Tensor, "
                      f"Tensor, Tensor, Tensor)")
    def bwd(wx, r, b, h, c, n, m, g_hs, g_h, g_c, g_n, g_m):
        with torch.no_grad():
            return _slstm_grads(wx, r, b, h, c, n, m, g_hs, g_h, g_c, g_n,
                                g_m)

    @bwd.register_fake
    def _(wx, r, b, h, c, n, m, *grads):
        return tuple(t.new_empty(t.shape) for t in (wx, r, b, h, c, n, m))

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    def backward(ctx, *grads):
        return bwd(*ctx.saved_tensors, *grads)

    fwd.register_autograd(backward, setup_context=setup_context)

    def step_flops(wx_shape):
        B, S, _, H, P = wx_shape
        return 2 * B * S * 4 * H * P * P

    @register_flop_formula(torch.ops.repro_torch.slstm_scan)
    def _(wx_shape, *args, **kwargs):
        return step_flops(wx_shape)

    @register_flop_formula(torch.ops.repro_torch.slstm_scan_grad)
    def _(wx_shape, *args, **kwargs):
        return 3 * step_flops(wx_shape)

    _SLSTM_OPS["fwd"] = fwd
    return fwd


def slstm_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    n_heads: int,
    state: Optional[dict] = None,  # {"h","c","n","m"}: (B, H, P)
):
    Bsz, S, D = x.shape
    P = D // n_heads
    f32 = torch.float32
    wx = split_heads(mm(x, p["w_gates"]), 4, n_heads, P)

    if state is None:
        h = torch.zeros((Bsz, n_heads, P), dtype=f32, device=x.device)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
        m = torch.full((Bsz, n_heads, P), float("-inf"), device=x.device)
    else:
        h, c, n, m = (state[k] for k in ("h", "c", "n", "m"))

    r = p["r_gates"].to(f32)  # (4, H, P, P)
    b = p["b_gates"].reshape(4, n_heads, P)
    # the recurrence is independent across the batch: on a process mesh
    # each rank runs it on its own rows, one operator for the whole scan
    ys, h, c, n, m = batch_local(_slstm_scan_op(), wx, r, b, h, c, n, m,
                                 batched=(0, 3, 4, 5, 6))
    y = ys.reshape(Bsz, S, D).to(x.dtype)
    y = rmsnorm_apply(p["out_norm"], y)
    up, z = torch.chunk(mm(y, p["w_up"]), 2, dim=-1)
    out = mm(up * F.silu(z), p["w_down"])
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_init_state(Bsz: int, d_model: int, n_heads: int, *,
                     device=None) -> dict:
    P = d_model // n_heads
    z = torch.zeros((Bsz, n_heads, P), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((Bsz, n_heads, P), float("-inf"), device=device)}
