"""The port's token stream (``repro_torch.data.tokens``) against the
reference's: the tables equal, and the keyed walk (a ``torch.Generator``
per (seed, step, host), where the reference folds ``jax.random`` keys)
holds the reference's data properties (``tests/test_data.py``) and walks
only along the table's successors."""
import numpy as np
import pytest

from repro.data import tokens as jtokens

from repro_torch.data import tokens
from repro_torch.data.tokens import (TokenStreamConfig, make_loader,
                                     synthetic_batch, unigram_entropy)


@pytest.mark.parametrize("vocab,branch,seed", [(256, 32, 3), (128, 8, 0),
                                               (1000, 32, 7)])
def test_tables_equal_reference(vocab, branch, seed):
    succ, logits = tokens._tables(TokenStreamConfig(vocab, branch, seed))
    jsucc, jlogits = jtokens._tables(jtokens.TokenStreamConfig(vocab, branch,
                                                               seed))
    np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
    assert str(np.asarray(jsucc).dtype) == "int32" == str(succ.numpy().dtype)


def test_tokens_deterministic_across_processes():
    cfg = TokenStreamConfig(vocab_size=256, seed=3)
    a = synthetic_batch(cfg, 17, 4, 32)
    b = synthetic_batch(cfg, 17, 4, 32)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())


def test_tokens_differ_across_steps_and_hosts():
    cfg = TokenStreamConfig(vocab_size=256)
    a = synthetic_batch(cfg, 0, 4, 32)
    b = synthetic_batch(cfg, 1, 4, 32)
    c = synthetic_batch(cfg, 0, 4, 32, host_id=1)
    assert not np.array_equal(a["tokens"].numpy(), b["tokens"].numpy())
    assert not np.array_equal(a["tokens"].numpy(), c["tokens"].numpy())


def test_labels_are_next_tokens():
    cfg = TokenStreamConfig(vocab_size=128)
    b = synthetic_batch(cfg, 0, 2, 16)
    assert b["tokens"].dtype == b["labels"].dtype
    assert str(b["tokens"].dtype) == "torch.int32"
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(),
                                  b["labels"][:, :-1].numpy())


def test_stream_has_learnable_structure():
    """Markov stream: bigram entropy must be well below unigram entropy."""
    cfg = TokenStreamConfig(vocab_size=128, branch=8)
    toks = synthetic_batch(cfg, 0, 16, 512)["tokens"].numpy()
    uni = unigram_entropy(cfg, 20_000)
    pairs = {}
    for row in toks:
        for x, y in zip(row[:-1], row[1:]):
            pairs.setdefault(int(x), []).append(int(y))
    cond = 0.0
    total = sum(len(v) for v in pairs.values())
    for x, ys in pairs.items():
        p = np.bincount(ys, minlength=cfg.vocab_size) / len(ys)
        p = p[p > 0]
        cond += len(ys) / total * float(-(p * np.log(p)).sum())
    assert cond < 0.8 * uni, (cond, uni)


def test_loader_interface():
    cfg = TokenStreamConfig(vocab_size=64)
    load = make_loader(cfg, batch=8, seq=16, host_id=0, n_hosts=2)
    b = load(0)
    assert tuple(b["tokens"].shape) == (4, 16)  # batch split across hosts


@pytest.mark.parametrize("branch", [8, 32])
def test_every_transition_is_a_successor(branch):
    """Each token (labels included) is one of its predecessor's ``branch``
    successors in the reference's table."""
    cfg = TokenStreamConfig(vocab_size=300, branch=branch, seed=5)
    jsucc, _ = jtokens._tables(jtokens.TokenStreamConfig(300, branch, 5))
    table = np.asarray(jsucc)
    for step in (0, 3):
        b = synthetic_batch(cfg, step, 4, 64)
        toks = np.concatenate([b["tokens"].numpy(),
                               b["labels"].numpy()[:, -1:]], axis=1)
        prev, nxt = toks[:, :-1].reshape(-1), toks[:, 1:].reshape(-1)
        assert (table[prev] == nxt[:, None]).any(axis=1).all()
