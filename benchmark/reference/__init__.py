"""The plain reference that decides ``correct``: plain PyTorch (``render.py``,
``fxaa.py``) and the comparisons (``compare.py``).  It imports neither JAX nor
anything of the program, and takes nothing the program made."""
