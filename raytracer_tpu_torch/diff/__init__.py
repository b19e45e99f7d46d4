"""Differentiable rendering: losses, parameters and training steps (``train``)."""
