"""Deterministic synthetic token pipeline, restart-exact (port of ``repro.data.tokens``).

The stream is a pure function of ``(seed, step)``, so a restarted training
loop replays exactly the batches it would have seen: the data side of the
bitwise restart contract.  Tokens are a Zipfian draw over the vocabulary
(the softmax loss sees a realistic non-uniform distribution) with
shifted-copy labels, so a model can learn next-token prediction.  The draw
is the reference's numpy code, so every batch is the reference's, bit for
bit, at any ``(seed, step, host_index, n_hosts)``.

Each host draws the global batch and keeps its contiguous row slice.  The
host index and count default to the rank and world size of the default
``torch.distributed`` group when one is initialised, else 0 and 1.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.config import Family, ModelConfig, ShapeCell


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    host_index: int | None = None  # the group's rank when one is initialised, else 0
    n_hosts: int | None = None  # the group's world size when one is initialised, else 1

    def __post_init__(self):
        group = dist.is_available() and dist.is_initialized()
        if self.host_index is None:
            self.host_index = dist.get_rank() if group else 0
        if self.n_hosts is None:
            self.n_hosts = dist.get_world_size() if group else 1
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks**-self.zipf_a
        self._probs = p / p.sum()
        self._perm = rng.permutation(self.vocab)  # break the rank/id correlation

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """This host's rows of the global batch of ``step``: int32 ``tokens``
        and ``labels``, each ``(global_batch / n_hosts, seq_len)``.  Hosts see
        disjoint shards whose union is the global batch."""
        rng = np.random.default_rng((self.seed, step))
        raw = rng.choice(self.vocab, size=(self.global_batch, self.seq_len + 1), p=self._probs)
        b = self.global_batch // self.n_hosts
        lo = self.host_index * b
        toks = self._perm[raw[lo: lo + b]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, cell: ShapeCell,
                     dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins for one cell's inputs, as tensors on the
    ``meta`` device (no storage): ``train`` {tokens, labels} (B, S),
    ``prefill`` {tokens} (B, S), ``decode`` {tokens} (B, 1); the
    encoder-decoder family adds ``encoder_frames`` for train and prefill."""
    dtype = dtype or cfg.param_dtype()
    b, s = cell.global_batch, cell.seq_len

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    specs: dict[str, torch.Tensor] = {}
    if cell.kind == "train":
        specs["tokens"] = meta((b, s), torch.int32)
        specs["labels"] = meta((b, s), torch.int32)
    elif cell.kind == "prefill":
        specs["tokens"] = meta((b, s), torch.int32)
    elif cell.kind == "decode":
        specs["tokens"] = meta((b, 1), torch.int32)
    if cfg.family is Family.ENC_DEC and cell.kind in ("train", "prefill"):
        specs["encoder_frames"] = meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return specs
