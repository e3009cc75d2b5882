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
construction: a Python loop over time with stabilized exponential gating.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.dtensor import keep_only

from .layers import _dense_init, _normal, einsum, init_rmsnorm, mm, \
    rmsnorm_apply
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

    q = mm(cx, p["wq"]).reshape(Bsz, S, H, P)
    k = mm(cx, p["wk"]).reshape(Bsz, S, H, P) * (P**-0.5)
    v = mm(x_in, p["wv"]).reshape(Bsz, S, H, P)
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
    wx = mm(x, p["w_gates"]).reshape(Bsz, S, 4, n_heads, P)

    if state is None:
        h = torch.zeros((Bsz, n_heads, P), dtype=f32, device=x.device)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
        m = torch.full((Bsz, n_heads, P), float("-inf"), device=x.device)
    else:
        h, c, n, m = (state[k] for k in ("h", "c", "n", "m"))

    r = p["r_gates"].to(f32)  # (4, H, P, P)
    b = p["b_gates"].reshape(4, n_heads, P)
    hs = []
    for t in range(S):
        rec = einsum("ghpq,bhq->bghp", r, h)  # (B,4,H,P)
        pre = wx[:, t].to(f32) + rec + b
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
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(Bsz, S, D).to(x.dtype)
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
