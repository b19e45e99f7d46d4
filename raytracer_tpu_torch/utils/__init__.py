"""Utilities of the port: checkpointing of training state (``checkpoint``)."""
