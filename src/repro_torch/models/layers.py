"""Attention primitives of the model stack (port of the parts of
`repro.models.layers` that paged decode needs: `_sdpa` and `causal_mask`).

Plain torch: float32 scores, a ``-1e30`` mask, softmax, in the JAX
package's layout (batch, sequence, heads, head_dim). The rest of the layer
library (embeddings, MLPs, norms, rotary) is still to port.
"""
from __future__ import annotations

from typing import Optional

import torch


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    mask: Optional[torch.Tensor],  # broadcastable to (B, H, Sq, Sk) or None
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores * (hd**-0.5)
    if mask is not None:
        # mask: (B, 1, Sq, Sk) -> (B, Hkv, group, Sq, Sk) broadcast
        scores = torch.where(mask[:, :, None, :, :], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])  # v head dim may differ (MLA)


def causal_mask(sq: int, sk: int, offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, sq, sk) — True where attendable. `offset` = kv positions already
    in cache before the current query block."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(sk, device=device)[None, :]
    return (kpos <= qpos)[None, None]
