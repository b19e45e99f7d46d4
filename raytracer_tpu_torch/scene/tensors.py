"""Packed scene arrays -> the renderer's tensors (the port's parameters)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import devices
from .device import DeviceScene, quantised_fields


def scene_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> DeviceScene:
    """Turn the field arrays of a packed scene into a ``DeviceScene`` of tensors.

    ``fields`` maps every ``DeviceScene`` field name to an array: this package's
    ``ScenePacker.frame()._asdict()``, or the JAX package's ``DeviceScene._asdict()``
    passed through ``np.asarray``; the quantised wide records, which the JAX
    package does not pack, are derived from the exact ones when both are
    absent.  Dtypes are kept (float32 / int32).  ``device`` defaults to
    ``cuda`` and raises without a card (``devices.resolve``).
    """
    dev = devices.resolve(device)
    if "wq_rec" not in fields and "wtq_rec" not in fields:
        fields = {**fields, **quantised_fields(fields)}
    missing = [k for k in DeviceScene._fields if k not in fields]
    if missing:
        raise KeyError(f"scene_from_numpy: missing fields {missing}")
    out = {}
    for k in DeviceScene._fields:
        a = np.array(fields[k], order="C")  # a copy; keeps 0-d scalars 0-d
        if a.dtype == np.float64 or a.dtype == np.int64:
            raise TypeError(f"scene field {k} is {a.dtype}; 32-bit arrays expected")
        out[k] = torch.from_numpy(a).to(dev)
    return DeviceScene(**out)
