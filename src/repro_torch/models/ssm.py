"""Mamba2-style SSD mixer, zamba2's SSM blocks (port of `repro.models.ssm`).

Prefill uses the chunkwise-parallel SSD algorithm (quadratic inside
length-`chunk` blocks, a linear scan across chunk boundaries); decode is the
O(1) recurrent update on a carried (H, N, P) state. `repro`'s ``lax.scan``s
are Python loops here (over chunks, and over the tokens of a decode call).

Shapes: B batch, S seq, H ssm heads, P head_dim, N state_dim, L chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import _dense_init, _normal, einsum, init_rmsnorm, mm, \
    rmsnorm_apply


def init_mamba2(generator, d_model: int, ssm, dtype, *, device=None) -> dict:
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.state_dim  # x, B, C all pass the causal conv
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": _dense_init(
            generator,
            (d_model, 2 * d_inner + 2 * ssm.state_dim + n_heads), dtype,
            device=device,
        ),
        "conv_w": _normal(generator, (ssm.conv_width, conv_ch), device, 0.1,
                          dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32,
                             device=device),  # a = -exp(a_log)
        "dt_bias": torch.full((n_heads,), -2.0, dtype=torch.float32,
                              device=device),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=device),
        "out_norm": init_rmsnorm(d_inner, dtype, device=device),
        "w_out": _dense_init(generator, (d_inner, d_model), dtype,
                             device=device),
    }


def _pad_seq(x: torch.Tensor, *, before: int = 0, after: int = 0):
    """`x` (B, S, ...) with zeros before and after its sequence: the values
    of ``F.pad``, as a cat, which DTensor shards on every torch (torch
    2.11's rule for ``F.pad`` fails on a 2-D mesh)."""
    def zeros(n):
        return x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))

    return torch.cat([zeros(before), x, zeros(after)], dim=1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). state: (B, K-1, C) tail
    of previous tokens (decode). Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        xp = _pad_seq(x, before=K - 1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else xp[:, :0]
    return F.silu(y + b), new_state


def _ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P)
    scale: torch.Tensor,  # (B, S, H) f32 — input scale (dt for SSD)
    loga: torch.Tensor,  # (B, S, H) f32 <= 0 — per-token log decay
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel gated linear recurrence
        h_t = exp(loga_t) h_{t-1} + scale_t * (B_t (x) x_t);  y_t = C_t . h_t
    (SSD with decoupled decay/scale — also the mLSTM matrix memory).
    Returns (y (B,S,H,P), h_final (B,H,N,P))."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    L = chunk
    assert S % L == 0, (S, L)
    nc = S // L
    f32 = torch.float32
    xc = xh.reshape(Bsz, nc, L, H, P).to(f32)
    dtc = scale.reshape(Bsz, nc, L, H)
    Bc = Bm.reshape(Bsz, nc, L, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, L, N).to(f32)

    seg = torch.cumsum(loga.reshape(Bsz, nc, L, H), dim=2)  # cum. log decay

    # --- intra-chunk (quadratic within L): scores[t,s] = exp(seg_t - seg_s)
    # * dt_s * (C_t . B_s), s <= t
    ratio = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    ratio = torch.where(tri[None, None, :, :, None], ratio,
                        torch.full_like(ratio, float("-inf")))
    dec = torch.exp(ratio)
    cb = einsum("bctn,bcsn->bcts", Cc, Bc)
    w = cb[..., None] * dec * dtc[:, :, None, :, :]  # (B,nc,t,s,H)
    y_intra = einsum("bctsh,bcshp->bcthp", w, xc)

    # --- chunk states: H_c = decay_all * H_{c-1} + sum_s exp(seg_L - seg_s)
    # dt_s B_s (x) x_s
    tail = torch.exp(seg[:, :, -1:, :] - seg)  # (B,nc,L,H)
    contrib = einsum("bcsh,bcsn,bcshp->bchnp", tail * dtc, Bc, xc)
    decay_all = torch.exp(seg[:, :, -1, :])  # (B,nc,H)

    h = (torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    h_prevs = []  # the state BEFORE each chunk
    for c in range(nc):
        h_prevs.append(h)
        h = h * decay_all[:, c, :, None, None] + contrib[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,nc,H,N,P)

    # --- inter-chunk: y_t += exp(seg_t) * C_t . H_{c-1}
    y_inter = einsum("bctn,bchnp->bcthp", Cc, h_prevs) * torch.exp(
        seg)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), h


def mamba2_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    ssm,
    state: Optional[dict] = None,  # decode: {"conv": (B,K-1,C), "ssd": (B,H,N,P)}
):
    """Returns (y, new_state). state=None -> chunked-parallel (prefill from
    scratch); state given -> stateful step(s) (decode)."""
    Bsz, S, D = x.shape
    d_inner = ssm.expand * D
    N, P = ssm.state_dim, ssm.head_dim
    H = d_inner // P
    f32 = torch.float32

    zxbcdt = mm(x, p["w_in"])
    z, xr, Bm, Cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, N, N, zxbcdt.shape[-1] - 2 * d_inner - 2 * N],
        dim=-1,
    )
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    xr, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)

    xh = xr.reshape(Bsz, S, H, P)
    dtf = torch.logaddexp(dt.to(f32) + p["dt_bias"],
                          torch.zeros((), dtype=f32, device=x.device))
    a = -torch.exp(p["a_log"])  # (H,)

    if state is None:
        L = min(ssm.chunk, S)
        pad = (-S) % L
        if pad:
            xh_p, dt_p, B_p, C_p = (_pad_seq(t, after=pad)
                                    for t in (xh, dtf, Bm, Cm))
        else:
            xh_p, dt_p, B_p, C_p = xh, dtf, Bm, Cm
        y, h_last = _ssd_chunked(xh_p, dt_p, dt_p * a, B_p, C_p, L)
        y = y[:, :S]
    else:
        # recurrent: S is small (usually 1)
        h = state["ssd"].to(f32)
        ys = []
        for t in range(S):
            dtt, bt, ct = dtf[:, t], Bm[:, t].to(f32), Cm[:, t].to(f32)
            alpha = torch.exp(dtt * a)  # (B,H)
            upd = einsum("bh,bn,bhp->bhnp", dtt, bt, xh[:, t].to(f32))
            h = h * alpha[:, :, None, None] + upd
            ys.append(einsum("bn,bhnp->bhp", ct, h))
        h_last = h
        y = torch.stack(ys, dim=1).to(x.dtype)

    y = y + xh.to(f32) * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rmsnorm_apply(p["out_norm"], y * F.silu(z))
    out = mm(y, p["w_out"])
    return out, {"conv": new_conv, "ssd": h_last}


def mamba2_init_state(Bsz: int, d_model: int, ssm, dtype, *,
                      device=None) -> dict:
    d_inner = ssm.expand * d_model
    H, N, P = d_inner // ssm.head_dim, ssm.state_dim, ssm.head_dim
    conv_ch = d_inner + 2 * N
    return {
        "conv": torch.zeros((Bsz, ssm.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                           device=device),
    }
