"""Checkpoints: npz shards + a JSON manifest (``ckpt.Checkpointer``)."""
from repro_torch.checkpoint.ckpt import Checkpointer

__all__ = ["Checkpointer"]
