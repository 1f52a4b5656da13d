"""Weight bridge: flax variable trees <-> the port's ``state_dict``.

A flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of
numpy arrays, as the JAX package's models hold them.  Module names are
the same in both packages; the conventions that differ
(``tests/test_transplant.py``, ``models/layers.py``):

* Conv2d ``HWIO`` <-> ``OIHW``; Conv1d ``WIO`` <-> ``OIW`` (GRN's trunk and
  gated blocks ``glu_{g}_{i}/...``, DiffWave's ``res{i}/...``; GRN's
  ``left_conv``/``right_conv``, which JAX runs as one product of the
  concatenated kernels, are two convs here under the same names);
* ConvTranspose2d: the JAX kernel ``[kh, kw, in, out]`` is the spatially
  flipped torch weight ``[in, out, kh, kw]`` (JAX runs the transposed conv
  as an lhs-dilated correlation);
* Dense ``kernel [in, out]`` <-> Linear ``weight [out, in]`` (also the
  time embedding's ``proj1``/``proj2`` and DiffWave's
  ``diffusion_projection``);
* PReLU ``alpha`` <-> ``weight``;
* BatchNorm ``BatchNorm_0/{scale, bias}`` and batch stats ``{mean, var}``
  <-> ``weight, bias, running_mean, running_var`` (``num_batches_tracked``
  has no flax counterpart and is set to 0, or to a given count);
* LayerNorm ``LayerNorm_0/{scale, bias}`` <-> ``weight, bias``; the
  ``scale`` of any other module without a kernel (``LayerNormOverF``,
  ``GroupNorm1``) <-> ``weight``;
* LSTM ``w_ih [in, 4h]``, ``w_hh``, ``b_ih``, ``b_hh`` <-> ``weight_ih_l0
  [4h, in]`` (transposed), ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``;
  GRU the same with ``_fwd`` <-> ``_l0`` and ``_bwd`` <-> ``_l0_reverse``;
* MultiHeadAttention ``w_in [d, 3d]``, ``b_in``, ``w_out``, ``b_out`` <->
  ``in_proj_weight [3d, d]`` (transposed), ``in_proj_bias``,
  ``out_proj_weight`` (transposed), ``out_proj_bias``;
* bare parameters (``k1``, ``k2``, ``k3``) keep their names.

:func:`payload_from_jax` carries a whole JAX trainer checkpoint (its nets
and optax states, step and plateau state) into the port's checkpoint
payload: ``ComplexDDPMTrainer``'s ``dis``, ``ddpm``, ``opt_dis``,
``opt_ddpm``, or ``ComplexTrainer``'s and ``MagTrainer``'s ``model``,
``opt``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from prior_diffuse_tpu_torch.models.layers import MultiHeadAttention

_BN = "BatchNorm_0"
_LN = "LayerNorm_0"
_STATS = {"mean": "running_mean", "var": "running_var"}
_KERNELS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _renamed(module: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """flax leaf -> (torch parameter, transposed) where the names differ."""
    if isinstance(module, nn.LSTM):
        return {"w_ih": ("weight_ih_l0", True), "w_hh": ("weight_hh_l0", True),
                "b_ih": ("bias_ih_l0", False), "b_hh": ("bias_hh_l0", False)}
    if isinstance(module, nn.GRU):
        return {f"{w}_{d}": (f"{t}_l0{sfx}", w.startswith("w"))
                for d, sfx in (("fwd", ""), ("bwd", "_reverse"))
                for w, t in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
    if isinstance(module, MultiHeadAttention):
        return {"w_in": ("in_proj_weight", True), "b_in": ("in_proj_bias", False),
                "w_out": ("out_proj_weight", True), "b_out": ("out_proj_bias", False)}
    return {}


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


def flax_to_state_dict(model: nn.Module, variables,
                       batches_tracked: int = 0) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` that holds the flax ``variables``;
    every BatchNorm's ``num_batches_tracked`` is ``batches_tracked``."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            mod_path = [p for p in path[:-1] if p not in (_BN, _LN)]
            module = model.get_submodule(".".join(mod_path))
            leaf = path[-1]
            renamed = _renamed(module)
            if collection == "batch_stats":
                name = _STATS[leaf]
            elif leaf in renamed:
                name, transposed = renamed[leaf]
                value = value.T if transposed else value
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
                out[".".join(mod_path + ["num_batches_tracked"])] = torch.tensor(
                    batches_tracked)
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
    if isinstance(module, nn.LayerNorm):
        return "params", (*mod_path, _LN, "scale" if name == "weight" else "bias")
    if isinstance(module, nn.PReLU):
        return "params", (*mod_path, "alpha")
    for leaf, (torch_name, _) in _renamed(module).items():
        if name == torch_name:
            return "params", (*mod_path, leaf)
    if name == "weight":
        return "params", (*mod_path, "kernel" if isinstance(module, _KERNELS) else "scale")
    return "params", (*mod_path, name)


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
        module = model.get_submodule(key.rpartition(".")[0])
        if path[-1] == "kernel":
            value = _kernel_to_flax(module, value)
        elif _renamed(module).get(path[-1], (None, False))[1]:
            value = value.T
        node = tree[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, order="C")
    return tree


def _adam_leaves(opt_state) -> Tuple[dict, dict]:
    """``(hyperparams, scale_by_adam state)`` of the JAX package's
    ``torch_adam`` state (``training/optim.py``: ``inject_hyperparams``
    over ``add_decayed_weights``, ``scale_by_adam``, ``scale(-1)``,
    ``scale_by_learning_rate``), as orbax restores it without a template:
    the named tuples as dicts, the chain as a list, empty states as None."""
    hyper = opt_state["hyperparams"]
    adam = [s for s in opt_state["inner_state"]
            if isinstance(s, dict) and set(s) == {"count", "mu", "nu"}]
    if set(hyper) != {"lr", "l2"} or len(adam) != 1:
        raise ValueError("not the optax state of the JAX package's torch_adam")
    return hyper, adam[0]


def adam_from_optax(model: nn.Module, opt_state, template: dict) -> dict:
    """The ``torch.optim.Adam`` ``state_dict`` of ``model``'s optimizer from
    the JAX ``torch_adam`` state ``opt_state``: ``mu`` / ``nu`` become
    ``exp_avg`` / ``exp_avg_sq``, the Adam ``count`` every parameter's
    ``step`` (no state before the first update, as torch keeps none), the
    (possibly halved) ``hyperparams`` ``lr`` and ``l2`` the groups' ``lr``
    and ``weight_decay``.  ``template`` is the ``state_dict`` of an Adam
    over ``model.parameters()``, whose parameter indices follow
    ``model.named_parameters()``."""
    hyper, adam = _adam_leaves(opt_state)
    count = int(np.asarray(adam["count"]))
    out = {"state": {}, "param_groups": copy.deepcopy(template["param_groups"])}
    for group in out["param_groups"]:
        group["lr"] = float(np.float32(hyper["lr"]))
        group["weight_decay"] = float(np.float32(hyper["l2"]))
    if count == 0:
        return out
    moments = {key: flax_to_state_dict(model, {"params": adam[key]})
               for key in ("mu", "nu")}
    names = [name for name, _ in model.named_parameters()]
    if sum(len(g["params"]) for g in out["param_groups"]) != len(names):
        raise ValueError("the template is not an optimizer over the model's parameters")
    for i, name in enumerate(names):
        out["state"][i] = {"step": torch.tensor(float(count)),
                           "exp_avg": moments["mu"][name],
                           "exp_avg_sq": moments["nu"][name]}
    return out


def payload_from_jax(payload, nets: Dict[str, nn.Module], opts: Dict[str, torch.optim.Adam]
                     ) -> dict:
    """The port's checkpoint payload (``training/base.py::ckpt_payload``)
    of a JAX trainer's (``prior_diffuse_tpu/training/base.py:212-253``), a
    tree of numpy arrays in dicts and lists as orbax restores it without a
    template.  ``nets`` (``dis``, ``ddpm``; or ``model``) and ``opts``
    (``opt_dis``, ``opt_ddpm``; or ``opt``, the optimizer of ``model``) are
    the port trainer's modules and optimizers, used for their layouts
    only.  Each BatchNorm's ``num_batches_tracked`` is the
    JAX step (one statistics update a step).  The JAX PRNG key has no torch
    counterpart: the payload's ``generator`` is None, and the trainer that
    restores it seeds its generator from its own seed."""
    state, meta = payload["state"], payload["meta"]
    step = int(np.asarray(meta["step"]))
    out = {name: flax_to_state_dict(net, state[name], batches_tracked=step)
           for name, net in nets.items()}
    for name, net in nets.items():
        if set(out[name]) != set(net.state_dict()):
            raise ValueError(f"the JAX {name!r} tree does not fit {type(net).__name__}")
        for key, value in net.state_dict().items():
            if out[name][key].shape != value.shape:
                raise ValueError(f"{name}.{key}: {tuple(out[name][key].shape)}, "
                                 f"expected {tuple(value.shape)}")
    for name, opt in opts.items():
        net = nets["model"] if name == "opt" else nets[name[len("opt_"):]]
        out[name] = adam_from_optax(net, state[name], opt.state_dict())
    return {"state": out, "meta": {
        "step": step, "generator": None,
        "plateau_prev": float(np.asarray(meta["plateau_prev"])),
        "plateau_best": float(np.asarray(meta["plateau_best"])),
        "plateau_bad": int(np.asarray(meta["plateau_bad"]))}}
