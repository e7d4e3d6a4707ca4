"""Optimizers: AdamW (``adam``) and RMCM quantization-aware training
wrappers (``qat``)."""
