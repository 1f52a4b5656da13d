"""Weight bridge: flax variable trees <-> the port's ``state_dict``.

A flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of
numpy arrays, as the JAX package's models hold them.  Module names are
the same in both packages; the conventions that differ
(``tests/test_transplant.py``, ``models/layers.py``):

* Conv2d ``HWIO`` <-> ``OIHW``; Conv1d ``WIO`` <-> ``OIW``;
* ConvTranspose2d: the JAX kernel ``[kh, kw, in, out]`` is the spatially
  flipped torch weight ``[in, out, kh, kw]`` (JAX runs the transposed conv
  as an lhs-dilated correlation);
* Dense ``kernel [in, out]`` <-> Linear ``weight [out, in]``;
* PReLU ``alpha`` <-> ``weight``;
* BatchNorm ``BatchNorm_0/{scale, bias}`` and batch stats ``{mean, var}``
  <-> ``weight, bias, running_mean, running_var`` (``num_batches_tracked``
  has no flax counterpart and is set to 0).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN = "BatchNorm_0"
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _kernel_to_torch(module: nn.Module, k: np.ndarray) -> np.ndarray:
    if isinstance(module, nn.ConvTranspose2d):
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    if isinstance(module, nn.Conv2d):
        return np.transpose(k, (3, 2, 0, 1))
    if isinstance(module, nn.Conv1d):
        return np.transpose(k, (2, 1, 0))
    if isinstance(module, nn.Linear):
        return k.T
    raise TypeError(f"no kernel convention for {type(module).__name__}")


def _kernel_to_flax(module: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(module, nn.ConvTranspose2d):
        return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
    if isinstance(module, nn.Conv2d):
        return np.transpose(w, (2, 3, 1, 0))
    if isinstance(module, nn.Conv1d):
        return np.transpose(w, (2, 1, 0))
    if isinstance(module, nn.Linear):
        return w.T
    raise TypeError(f"no kernel convention for {type(module).__name__}")


def flax_to_state_dict(model: nn.Module, variables) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` that holds the flax ``variables``."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            mod_path = [p for p in path[:-1] if p != _BN]
            module = model.get_submodule(".".join(mod_path))
            leaf = path[-1]
            if collection == "batch_stats":
                name = _STATS[leaf]
            elif leaf == "kernel":
                name, value = "weight", _kernel_to_torch(module, value)
            elif leaf in ("scale", "alpha"):
                name = "weight"
            else:
                name = leaf  # bias
            # a fresh C-ordered copy: flipped size-1 axes keep negative strides
            out[".".join(mod_path + [name])] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C"))
            if isinstance(module, nn.modules.batchnorm._BatchNorm):
                out[".".join(mod_path + ["num_batches_tracked"])] = torch.tensor(0)
    return out


def flax_key(model: nn.Module, key: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """``(collection, path)`` of a ``state_dict`` key in the flax variable
    tree, e.g. ``core.en.bn1.weight`` -> ``("params", ("core", "en", "bn1",
    "BatchNorm_0", "scale"))``; None for ``num_batches_tracked``."""
    *mod_path, name = key.split(".")
    if name == "num_batches_tracked":
        return None
    module = model.get_submodule(".".join(mod_path))
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        if name in _STATS.values():
            return "batch_stats", (*mod_path, _BN, "mean" if name == "running_mean" else "var")
        return "params", (*mod_path, _BN, "scale" if name == "weight" else "bias")
    if isinstance(module, nn.PReLU):
        return "params", (*mod_path, "alpha")
    return "params", (*mod_path, "kernel" if name == "weight" else name)


def state_dict_to_flax(model: nn.Module, state_dict) -> dict:
    """The flax variable tree ``{"params", "batch_stats"}`` of a ``state_dict``
    (or of any mapping of its keys to parameter-shaped tensors, such as
    Adam's moments)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        found = flax_key(model, key)
        if found is None:
            continue
        collection, path = found
        value = tensor.detach().cpu().numpy()
        if path[-1] == "kernel":
            value = _kernel_to_flax(model.get_submodule(key.rsplit(".", 1)[0]), value)
        node = tree[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, order="C")
    return tree
