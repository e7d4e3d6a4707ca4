"""PyTorch/CUDA port of the ICARUS PLCore render path (see ROADMAP.md).

Imports torch and numpy only: nothing of JAX and nothing of ``repro``.
"""
