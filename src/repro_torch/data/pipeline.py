"""Deterministic, shardable synthetic token pipeline (port of
`repro.data.pipeline`: `DataConfig`, `TokenPipeline` and `PrefetchIterator`
are `repro`'s numpy code, so batches are array-equal for every (seed, step,
shard); `device_put_batch` copies a batch to a torch device, or a rank's
rows of it onto a process mesh).

Production posture without network access: a seeded generator standing in for
a tokenized corpus reader. Properties a 1000-node fleet needs and tests
verify:
  * deterministic in (seed, step, shard) — restart/elastic-reshard safe:
    batch content depends only on the global step, never on worker count;
  * host-sharded: each data-parallel host materializes only its slice;
  * background prefetch with a bounded queue (overlaps host->device copy);
  * straggler-aware skip: `skip_to(step)` is O(1) (no replay), so a restarted
    or lagging worker can rejoin at the fleet's current step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # zipf-ish unigram skew so embedding-gather coalescing has realistic reuse
    zipf_alpha: float = 1.1


class TokenPipeline:
    """Counter-based deterministic batches: batch(step, shard) is a pure
    function — the RNG is re-seeded from (seed, step) every call."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard_index])
        )
        # Zipf-distributed tokens (clipped) — realistic id reuse for the
        # coalesced embedding gather.
        raw = rng.zipf(cfg.zipf_alpha, size=(self.local_batch, cfg.seq_len))
        tokens = (raw - 1) % cfg.vocab_size
        return {"tokens": tokens.astype(np.int32)}

    def skip_to(self, step: int) -> None:
        self._step = step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b


class PrefetchIterator:
    """Bounded background prefetch (host-side pipeline overlap)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def work():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()


def local_rows(arr: np.ndarray, sharding) -> np.ndarray:
    """This rank's rows of a global batch array under `sharding` (a
    `sharding.rules.Sharding`): the pipeline is deterministic in (seed,
    step), so every rank builds the global batch and keeps its slice."""
    from repro_torch.sharding.dtensor import local_chunk

    return local_chunk(torch.from_numpy(np.ascontiguousarray(arr)),
                       sharding.mesh, sharding.placements).numpy()


def device_put_batch(batch: Dict[str, np.ndarray], device=None,
                     shardings=None) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (default: the card, see
    `core.runtime.resolve_device`). A copy to the card goes through pinned
    host memory and does not block the host; on the CPU the tensors share
    the arrays' memory. With `shardings` ({name: `sharding.rules.Sharding`}
    on a process mesh, from `batch_pspecs`) each array becomes a DTensor of
    which this rank copies only its rows."""
    device = resolve_device(device)
    out = {}
    for name, arr in batch.items():
        sh = shardings.get(name) if shardings else None
        t = torch.from_numpy(np.ascontiguousarray(
            arr if sh is None else local_rows(arr, sh)))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if sh is not None:
            from repro_torch.sharding.dtensor import wrap

            t = wrap(t, sh.mesh, sh.placements, shape=arr.shape)
        out[name] = t
    return out
