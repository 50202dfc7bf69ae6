"""Streaming checkpoints in the JAX package's format (``checkpointing/store.py``)."""
