"""Utilities of the port: checkpointing of training state (``checkpoint``),
ray-throughput metrics (``stats``), timers (``timer``), PNG IO without an
imaging package (``image``), debug validators (``debug``) and the program's
spans and launch counters (``trace``)."""
