"""Gradient compression for the scarce cross-pod axis (port of
`repro.optim.compression`).

Error-feedback int8 quantization: each worker quantizes its gradient
contribution to int8 with a per-tensor scale before the cross-pod
all-reduce, and carries the quantization residual into the next step's
gradient (error feedback keeps the method unbiased in the long run,
Karimireddy et al. 2019). Per-tensor means per `repro` leaf: a stacked
subtree's layers share one scale (`optim.tree.leaves`). ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.sharding.dtensor import like, replicate, replication

from .tree import leaves, map_tree, named_tensors


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Quantize (grads + residual) per `repro` leaf; return (dequantized
    grads, in the gradients' dtypes, to feed the cross-pod all-reduce; new
    residual). Both are new trees of the gradients' structure.

    On DTensors the gradient is taken on its residual's layout first (a
    pending data-axis ``Partial(sum)`` reduced: the data-reduced gradient
    is compressed, as `repro` sees one global array), and the scale comes
    from the leaf's global max, replicated over the mesh."""
    G, R = named_tensors(grads), named_tensors(residual)
    dq, res = {}, {}
    with replication(grads):
        for leaf in leaves(grads):
            gf = {n: like(G[n], R[n]).to(torch.float32) + R[n]
                  for n in leaf.names}
            amax = torch.stack([replicate(torch.max(torch.abs(t)))
                                for t in gf.values()])
            scale = torch.clamp(amax.max(), min=1e-12) / 127.0
            for n, t in gf.items():
                d = dequantize_int8(torch.clamp(torch.round(t / scale), -127,
                                                127).to(torch.int8), scale)
                dq[n], res[n] = d.to(G[n].dtype), t - d
    take = lambda g, t: t  # noqa: E731  (the tensor of that name)
    return map_tree(take, grads, dq), map_tree(take, grads, res)


def init_residual(params: Any) -> Any:
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def topk_sparsify(x: torch.Tensor, frac: float = 0.01) -> torch.Tensor:
    """Alternative compressor: keep the top-`frac` magnitudes (flat), zero
    the rest; every element tied with the k-th magnitude is kept, as in
    `repro` (``>=`` the threshold)."""
    xf = x.to(torch.float32).reshape(-1)
    k = max(1, int(frac * xf.numel()))
    mags = torch.sort(torch.abs(xf), descending=True, stable=True).values
    thresh = mags[k - 1]
    kept = torch.where(torch.abs(xf) >= thresh, xf, torch.zeros_like(xf))
    return kept.reshape(x.shape).to(x.dtype)
