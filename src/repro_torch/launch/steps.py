"""Step builders of the serving path: ``make_prefill_step`` /
``make_decode_step`` wrap the model's serving entry points as pure
functions of explicit state (the reference's, whose train steps come with
LM training)."""
from __future__ import annotations


def make_prefill_step(model):
    def prefill_step(params, batch, capacity=None):
        return model.prefill(params, batch, capacity)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, token, pos):
        return model.decode(params, cache, token, pos)

    return decode_step
