"""The JAX package's native checkpoint directories, read without JAX.

`dig_tpu/utils/checkpoint.py:85-112` writes ``checkpoint-{tag}/`` as
``arrays.npz`` (the leaves, ``leaf_0`` ... in flattening order),
``treedef.pkl`` (the pickled `jax.tree_util.PyTreeDef` of {"params",
"opt_state"[, "ema_params"]}) and ``meta.json``.  The pickle names
``jaxlib._jax.pytree.PyTreeDef`` (made by NEWOBJ, filled by BUILD) and
holds, as its state, the registry and the list of its nodes in post-order,
each ``(kind, arity, node data, custom type, leaves, nodes)``.
`_TreedefUnpickler` gives stand-ins for every global of ``jax``,
``jaxlib``, ``flax`` and ``optax`` and refuses any other, so nothing is
imported; `read_tree` rebuilds the nested dicts, lists and tuples from
the nodes: kinds 0 leaf, 1 None, 2 tuple, 3 namedtuple (`NamedNode`,
named by its class's qualified name), 4 list, 5 dict (its keys are the
node data), 6 a custom node, of which flax's `FrozenDict` (a dict) is read.
An unknown kind or custom node, or a leaf count that differs from
``arrays.npz``, raises `ValueError` with a message.

Optax's state namedtuples carry no field names in the pickle; `FIELDS`
names those the port maps onto its own optimizer (`load_into_state`):
`ScaleByAdamState` (AdamW's moments), `MultiStepsState` (`--update_freq`)
and the {"inner", "count"} dict of `create_optimizer`.  Any other
optimizer state is refused on resume, with a message naming its class.
"""

from __future__ import annotations

import io
import json
import pickle

import numpy as np
import torch

from dig_tpu_torch.utils.convert import _encoder, moco_params_from_jax, params_from_jax

# the namedtuples whose fields the port reads, by qualified class name
FIELDS = {
    "optax._src.transform.ScaleByAdamState": ("count", "mu", "nu"),
    "optax.transforms._accumulation.MultiStepsState": (
        "mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"),
}
_JAX_PACKAGES = ("jax", "jaxlib", "flax", "optax")
_FROZEN_DICT = "flax.core.frozen_dict.FrozenDict"


class _Global:
    """A stand-in for a global of the JAX packages: its qualified name."""

    def __init__(self, module: str, name: str):
        self.qualname = f"{module}.{name}"

    def __repr__(self):
        return self.qualname


class _PyTreeDef:
    """The stand-in for ``PyTreeDef``: NEWOBJ makes it, BUILD fills it."""

    def __setstate__(self, state):
        self.registry, self.nodes = state


class _TreedefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] not in _JAX_PACKAGES:
            raise pickle.UnpicklingError(
                f"treedef.pkl names {module}.{name}, which is not a JAX-package global")
        if name == "PyTreeDef":
            return _PyTreeDef
        return _Global(module, name)


class NamedNode:
    """A namedtuple node: its class's qualified name and its children, in
    field order; `field` reads one by name where `FIELDS` knows the class."""

    def __init__(self, qualname: str, children: list):
        self.qualname, self.children = qualname, children

    def field(self, name: str):
        if self.qualname not in FIELDS:
            raise ValueError(f"{self.qualname}: the port does not know this optimizer "
                             f"state's fields")
        return self.children[FIELDS[self.qualname].index(name)]

    def __repr__(self):
        return f"{self.qualname}({len(self.children)})"


def _unflatten(nodes, leaves):
    stack, it = [], iter(leaves)
    for kind, arity, data, custom, _, _ in nodes:
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == 0:
            stack.append(next(it))
        elif kind == 1:
            stack.append(None)
        elif kind == 2:
            stack.append(tuple(children))
        elif kind == 3:
            stack.append(NamedNode(getattr(data, "qualname", str(data)), children))
        elif kind == 4:
            stack.append(list(children))
        elif kind == 5:
            stack.append(dict(zip(data, children)))
        elif kind == 6 and getattr(custom, "qualname", None) == _FROZEN_DICT:
            stack.append(dict(zip(data, children)))
        elif kind == 6:
            raise ValueError(f"treedef.pkl holds a custom node {custom!r} the port cannot read")
        else:
            raise ValueError(f"treedef.pkl holds a node of unknown kind {kind}")
    if len(stack) != 1:
        raise ValueError(f"treedef.pkl does not describe one tree ({len(stack)} roots)")
    return stack[0]


def read_tree(treedef_bytes: bytes, arrays_bytes: bytes):
    """The saved tree: nested dicts / lists / tuples / `NamedNode`s of numpy
    arrays."""
    treedef = _TreedefUnpickler(io.BytesIO(treedef_bytes)).load()
    if not isinstance(treedef, _PyTreeDef):
        raise ValueError("treedef.pkl does not hold a PyTreeDef")
    with np.load(io.BytesIO(arrays_bytes), allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    n_leaves = sum(1 for node in treedef.nodes if node[0] == 0)
    if n_leaves != len(leaves):
        raise ValueError(f"treedef.pkl has {n_leaves} leaves, arrays.npz {len(leaves)}")
    return _unflatten(treedef.nodes, leaves)


def read_native(read_bytes) -> dict:
    """A native directory through `read_bytes(name)` (local or remote): its
    trees plus "step" and, where saved, "extra"."""
    payload = {"native": read_tree(read_bytes("treedef.pkl"), read_bytes("arrays.npz"))}
    meta = json.loads(read_bytes("meta.json").decode())
    payload["step"] = meta["step"]
    if "extra" in meta:
        payload["extra"] = meta["extra"]
    return payload


def encoder_state_dict(trees: dict, patch_size: int = 4) -> dict:
    """The encoder's tensors, keyed below it, as `dig_tpu` takes them for
    `--finetune` and the distillation teacher: ``params["encoder"]``, or
    the params themselves when they are an encoder's."""
    params = trees["params"]
    return _encoder(params.get("encoder", params), patch_size)


def model_state_dict(trees: dict, pretrain: bool, patch_size: int = 4) -> dict:
    """The whole model's state dict: a pre-training model's student and
    momentum branch, or a recognizer's parameters."""
    if pretrain:
        return moco_params_from_jax(trees["params"], trees.get("ema_params", {}), patch_size)
    return params_from_jax(trees["params"], patch_size)


def _adam_state(opt_state) -> tuple:
    """(ScaleByAdamState, update count, MultiStepsState or None) of the
    JAX factory's optimizer state; `ValueError` naming the class of any
    other."""
    multi = None
    if isinstance(opt_state, NamedNode) and opt_state.qualname.endswith("MultiStepsState"):
        multi, opt_state = opt_state, opt_state.field("inner_opt_state")
    if not (isinstance(opt_state, dict) and sorted(opt_state) in (["count", "inner"],
                                                                  ["count", "inner", "slow"])):
        raise ValueError(f"the checkpoint's optimizer state ({_describe(opt_state)}) is not "
                         f"dig_tpu's create_optimizer state")
    inner = opt_state["inner"]
    if (not isinstance(inner, NamedNode) or "slow" in opt_state
            or inner.qualname != "optax._src.transform.ScaleByAdamState"):
        raise ValueError(f"resuming {_describe(inner)} optimizer state from a native dig_tpu "
                         f"checkpoint is not supported: only AdamW's (ScaleByAdamState) is "
                         f"carried into the port")
    return inner, int(np.asarray(opt_state["count"])), multi


def _describe(node) -> str:
    if isinstance(node, NamedNode):
        return node.qualname
    if isinstance(node, tuple):  # an optax chain's states
        return "(" + ", ".join(_describe(n) for n in node) + ")"
    return type(node).__name__


def load_into_state(state, payload: dict, patch_size: int = 4):
    """Put a native payload into a port `TrainState`, in place: the model
    (a pre-training model's student and momentum branch; a recognizer's
    parameters), AdamW's moments (mu -> exp_avg, nu -> exp_avg_sq, through
    the same layout maps as the parameters: transposes, reshapes and
    concatenations carry them too) and step tensors, the optimizer's count,
    under `--update_freq` its running mean, and the step counter."""
    from dig_tpu_torch.optim import AdamW
    from dig_tpu_torch.parallel.sharding import load_full_state_dict, local_view

    trees = payload["native"]
    pretrain = hasattr(state.model, "reset_momentum")
    load_full_state_dict(state.model, model_state_dict(trees, pretrain, patch_size))
    opt = state.optimizer
    inner, count, multi = _adam_state(trees["opt_state"])
    if not isinstance(opt, AdamW):
        raise ValueError(f"a native dig_tpu checkpoint's AdamW state cannot resume the "
                         f"port's {type(opt).__name__} ({getattr(opt, 'rule', '')})")
    to_sd = (lambda t: moco_params_from_jax(t, {}, patch_size)) if pretrain else (
        lambda t: params_from_jax(t, patch_size))
    mu, nu = to_sd(inner.field("mu")), to_sd(inner.field("nu"))
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for name, p in zip(opt.names, opt.params):
        opt.inner.state[p] = {"step": torch.tensor(float(np.asarray(inner.field("count"))),
                                                   dtype=step_dtype),
                              "exp_avg": local_view(p, mu[name].to(p.device, p.dtype)),
                              "exp_avg_sq": local_view(p, nu[name].to(p.device, p.dtype))}
    opt.count = count
    if multi is not None and opt.update_freq > 1:
        acc = to_sd(multi.field("acc_grads"))
        opt.acc = [local_view(p, acc[name].to(p.device, p.dtype))
                   for name, p in zip(opt.names, opt.params)]
        opt.mini_step = int(np.asarray(multi.field("mini_step")))
    state.step = int(payload["step"])
    return state
