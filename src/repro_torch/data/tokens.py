"""Deterministic synthetic token stream for the LM substrate.

A fixed first-order Markov chain over the vocabulary (Zipf-ish stationary
distribution, per-state branching factor ~32) so training has real,
learnable structure: the loss drops measurably below unigram entropy
within a few hundred steps.

Determinism contract (fault tolerance): batch content is a pure function of
(step, host_shard), so after a checkpoint restore training sees exactly the
token stream it would have seen uninterrupted.

The successor and logit tables come from ``np.random.RandomState(seed)``,
as the reference's do, and equal them. The walk's Gumbel noise and start
states come from a ``torch.Generator`` seeded by a pure function of
``(seed, step, host_id)``: the reference draws them from ``jax.random``
keys, whose stream cannot be repeated, so the port's batches hold the
reference's properties, not its tokens. Batches are built on the CPU (the
same tokens on every device); the caller moves them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    branch: int = 32          # successors per state
    seed: int = 0


def _tables(cfg: TokenStreamConfig):
    """Per-state successor table (V, branch) + logits, the reference's."""
    rng = np.random.RandomState(cfg.seed)
    succ = rng.randint(0, cfg.vocab_size,
                       (cfg.vocab_size, cfg.branch)).astype(np.int32)
    logits = rng.gumbel(size=(cfg.vocab_size, cfg.branch)).astype(np.float32)
    return torch.from_numpy(succ), torch.from_numpy(logits)


_CACHE = {}


def _cached_tables(cfg: TokenStreamConfig):
    if cfg not in _CACHE:
        _CACHE[cfg] = _tables(cfg)
    return _CACHE[cfg]


def _step_generator(seed: int, step: int, host_id: int) -> torch.Generator:
    """A CPU generator whose seed is a pure function of (seed, step,
    host_id) (the reference folds ``step`` and ``host_id`` into
    ``PRNGKey(seed + 1)``)."""
    ss = np.random.SeedSequence([seed + 1, step, host_id])
    return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0]))


def synthetic_batch(cfg: TokenStreamConfig, step: int, batch: int, seq: int,
                    host_id: int = 0, n_hosts: int = 1) -> dict:
    """{tokens, labels} (int32, on the CPU) for one step. labels[t] =
    tokens[t+1] (pre-shifted)."""
    succ, logits = _cached_tables(cfg)
    gen = _step_generator(cfg.seed, step, host_id)
    state = torch.randint(0, cfg.vocab_size, (batch,), generator=gen)
    # Gumbel noise, -log(Exp(1)), for every step of the walk at once
    g = -torch.empty((seq, batch, cfg.branch)).exponential_(generator=gen).log()
    toks = [state]
    for t in range(seq):            # need seq+1 tokens for shifted labels
        choice = torch.argmax(logits[state] + g[t], dim=-1)
        state = succ[state, choice].long()
        toks.append(state)
    toks = torch.stack(toks, 1).to(torch.int32)            # (batch, seq+1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_loader(cfg: TokenStreamConfig, batch: int, seq: int,
                host_id: int = 0, n_hosts: int = 1):
    """step -> batch callable; the training driver owns the step counter."""
    local_batch = batch // n_hosts

    def load(step: int) -> dict:
        return synthetic_batch(cfg, step, local_batch, seq, host_id, n_hosts)

    return load


def unigram_entropy(cfg: TokenStreamConfig, n_samples: int = 200_000) -> float:
    """Empirical unigram entropy (nats): the ceiling a context-free model
    can reach."""
    b = synthetic_batch(cfg, 0, 64, n_samples // 64)
    toks = b["tokens"].numpy().reshape(-1)
    counts = np.bincount(toks, minlength=cfg.vocab_size).astype(np.float64)
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())
