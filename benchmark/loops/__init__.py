"""The loops a window drives, one file a loop, found by the ``loop`` key of a
traffic mix's file (``benchmark/mixes/<traffic>.json``), which holds every
parameter the loop reads.  A new mix of an existing loop is a data file alone.

A loop module defines ``Loop(config, mix, seed, device, tracer)`` with:

- ``setup()``: build the scene from the configuration, hand it to the program,
  upload it and warm up the shapes this mix uses (counted in ``setup_s``);
- ``frame(i)``: one unit of work of the window (a frame), ending on a read on
  the host; it keeps what the check will judge;
- ``profile_from(after)``: the frame a ``--trace 1`` run's profiler starts at,
  from ``after`` (the mix's ``profile_after``) on; optional;
- ``release()``: drop the program's state, keeping the outputs to be judged;
- ``check(control)``: ``[(name, value, limit)]``, the window's outputs against
  the reference's; with ``control`` the control's outputs (the reference in the
  next precision down) stand in the program's place.
"""
