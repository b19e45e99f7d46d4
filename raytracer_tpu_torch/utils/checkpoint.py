"""Checkpoint / resume of training state (counterpart of
``raytracer_tpu/utils/checkpoint.py``).

Saves the differentiable scene parameters and a ``torch.optim`` optimizer's
``state_dict()`` as one ``.npz`` keyed by step, without pickle: tensors become
arrays, and the optimizer's hyper-parameters (``param_groups``) a JSON string.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def save(path: str, params, opt_state: dict | None = None, step: int = 0) -> None:
    """params: {name: tensor}; opt_state: ``optimizer.state_dict()`` or None."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"param:{k}": v.detach().cpu().numpy() for k, v in params.items()}
    if opt_state is not None:
        for i, slots in opt_state["state"].items():
            for name, v in slots.items():
                flat[f"opt:state:{i}:{name}"] = torch.as_tensor(v).detach().cpu().numpy()
        groups = json.dumps(opt_state["param_groups"])
        flat["opt:param_groups"] = np.frombuffer(groups.encode(), dtype=np.uint8)
    flat["step"] = np.int64(step)
    np.savez(path, **flat)


def restore(path: str):
    """Returns (params {name: CPU tensor}, optimizer state dict or None, step).
    Load the state with ``optimizer.load_state_dict``, which moves it to the
    parameters' device."""
    data = np.load(path, allow_pickle=False)
    params = {k[len("param:"):]: torch.from_numpy(data[k])
              for k in data.files if k.startswith("param:")}
    step = int(data["step"])
    if "opt:param_groups" not in data.files:
        return params, None, step
    groups = json.loads(data["opt:param_groups"].tobytes().decode())
    for g in groups:  # JSON turned tuples (Adam's betas) into lists
        for k, v in g.items():
            if k != "params" and isinstance(v, list):
                g[k] = tuple(v)
    state: dict = {}
    for k in data.files:
        if k.startswith("opt:state:"):
            _, _, i, name = k.split(":", 3)
            state.setdefault(int(i), {})[name] = torch.from_numpy(data[k])
    return params, {"state": state, "param_groups": groups}, step
