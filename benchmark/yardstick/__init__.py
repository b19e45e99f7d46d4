"""The benchmark's yardstick: what every cell is measured and judged with.

Frozen copies of the program's scene construction (meshes, assets, camera path,
animation).  Each file names the source it was copied from, by ``file:line``.
Later changes add files beside these and never edit them, so that a change to
the program cannot move the yardstick it is measured with.
"""
