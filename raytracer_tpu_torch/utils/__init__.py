"""Utilities of the port: checkpointing of training state (``checkpoint``),
ray-throughput metrics (``stats``), timers (``timer``), PNG IO without an
imaging package (``image``) and debug validators (``debug``)."""
