from .renderer import Renderer, render_with_stats  # noqa: F401
