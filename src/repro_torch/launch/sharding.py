"""Sharding rules (``repro/launch/sharding.py``): Megatron-style tensor
parallelism and a ZeRO-1 optimizer state, as layout specs.

A spec gives one entry a tensor dimension: None (replicated), a mesh
axis name, or a tuple of names (sharded over their product), the
reference's ``PartitionSpec`` as a plain tuple.  The rules are pure
functions of a leaf's key path (``/``-joined dict keys and list
indices, the reference's), its shape, the mesh's {axis name: size} and
the config's :class:`repro_torch.configs.ShardingRules`, so they need
no live mesh: the reference's production meshes, (16, 16) and
(2, 16, 16), exist on no single card.  :func:`placements` turns a spec
into DTensor placements on a live ``DeviceMesh``.

Layout, as the reference's:

  * activations:  batch over ("pod", "data");
  * weights:      column-parallel (output dim over "model") for
                  up-projections, row-parallel (contracting dim over
                  "model") for down-projections;
  * experts:      the expert dim over the first dividing axis tuple of
                  ("data", "model"), ("pod", "model"), ("model",),
                  ("data",); the per-expert hidden dim also over a free
                  data axis unless ``moe_ep``;
  * optimizer:    fp32 master and moments sharded like the weights plus
                  the ``fsdp_axes`` on the largest free dim (ZeRO-1);
                  the step replicated;
  * decode cache: batch over ("pod", "data"), the KV sequence over
                  "model" (and the data axes when B = 1), recurrent
                  states over their lanes or heads.

Every rule is divisibility-guarded, so one set serves the 2B dense
model, the 671B MoE and a mesh of one.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from repro_torch.configs.base import ShardingRules
from repro_torch.optim import AdamState

Spec = Tuple[Any, ...]


def _axes_prod(sizes: Mapping[str, int], axes: Tuple[str, ...]) -> int:
    out = 1
    for a in axes:
        out *= sizes.get(a, 1)
    return out


def _present(sizes: Mapping[str, int], axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in sizes)


def _fit(sizes: Mapping[str, int], dim: int, axes) -> Any:
    """The longest prefix of ``axes`` whose product divides ``dim``."""
    axes = _present(sizes, axes)
    while axes and (dim % _axes_prod(sizes, axes) != 0
                    or _axes_prod(sizes, axes) > dim):
        axes = axes[:-1]
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _first_fit(sizes: Mapping[str, int], dim: int, candidates) -> Any:
    """The first candidate axis tuple whose product divides ``dim``."""
    for cand in candidates:
        cand = _present(sizes, cand)
        if cand and dim % _axes_prod(sizes, cand) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


# ---------------------------------------------------------------------------
# parameters (Megatron tensor parallelism)
# ---------------------------------------------------------------------------
_COL_PARALLEL = {"wq", "wk", "wv", "w_in", "w_gate", "w_r", "w_k", "w_v",
                 "w_g", "w_x", "w_y", "wq_b", "wkv_b", "decay_b", "w_a",
                 "w_i"}
_ROW_PARALLEL = {"wo", "w_out", "w_o"}
_REPLICATED_2D = {"wq_a", "wkv_a", "decay_a", "router"}
_MODEL_1D = {"log_lambda", "conv_b", "b_a", "b_i", "w0", "ln_scale", "b_in",
             "bq", "bk", "bv"}


def param_spec(path: str, shape: Tuple[int, ...], sizes: Mapping[str, int],
               rules: ShardingRules) -> Spec:
    """The spec of the parameter at key path ``path``.  Stacked
    ``cycles/`` and ``encoder/`` leaves keep their leading (cycle) axis
    unsharded; the U-Net's convs and denses are replicated."""
    model = rules.heads
    d = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    stacked = path.startswith(("cycles/", "encoder/"))
    off = 1 if (stacked and d > 0) else 0

    def spec(*entries):
        full = [None] * d
        for i, ax in enumerate(entries):
            full[off + i] = ax
        return tuple(full)

    def fit(i, axes):
        return _fit(sizes, shape[off + i], axes)

    if leaf == "embed":
        return (_fit(sizes, shape[0], rules.vocab), None)
    if leaf == "lm_head":
        return (None, _fit(sizes, shape[1], rules.vocab))

    if "/moe/" in path and leaf in ("w_gate", "w_in", "w_out") \
            and d - off == 3:
        # ("data", "model") first: the expert-parallel token layout is
        # then a refinement of the batch layout
        e_ax = _first_fit(sizes, shape[off], [("data", "model"),
                                              ("pod", "model"), ("model",),
                                              ("data",)])
        used = set(_spec_axes(e_ax))
        de_cands = () if rules.moe_ep \
            else tuple(a for a in ("data", "pod") if a not in used)
        if leaf in ("w_gate", "w_in"):
            return spec(e_ax, None, _fit(sizes, shape[off + 2], de_cands))
        return spec(e_ax, _fit(sizes, shape[off + 1], de_cands), None)

    if d - off == 2:
        if leaf in _COL_PARALLEL or leaf == "conv_w":
            return spec(None, fit(1, model))
        if leaf in _ROW_PARALLEL or leaf == "u":   # u: RWKV's (H, hd)
            return spec(fit(0, model), None)
        return spec(None, None)             # the routers, U-Net denses
    if d - off == 1 and leaf in _MODEL_1D:
        return spec(fit(0, model))
    return tuple([None] * d)                # LoRA mixes, U-Net convs, ...


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples,
    paths as the reference's key paths."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        items = [_map_with_path(fn, v, f"{prefix}{k}/")
                 for k, v in zip(keys, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(prefix[:-1], tree)


def param_specs(params, sizes: Mapping[str, int], rules: ShardingRules):
    """A tree like ``params`` (any leaves with a ``shape``: tensors on
    ``meta`` will do) holding each leaf's spec.  A spec is a tuple:
    walk the result beside ``params``, not on its own."""
    return _map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), sizes,
                                      rules), params)


def zero1_extend(spec: Spec, shape: Tuple[int, ...],
                 sizes: Mapping[str, int], rules: ShardingRules) -> Spec:
    """``spec`` with the free ``fsdp_axes`` added on the largest
    dimension that takes them: the optimizer state's sharding."""
    used = set()
    for e in spec:
        used |= set(_spec_axes(e))
    free = tuple(a for a in rules.fsdp_axes if a in sizes and a not in used)
    if not free:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[i] is not None:
            continue
        ax = _fit(sizes, shape[i], free)
        if ax is not None:
            entries[i] = ax
            break
    return tuple(entries)


def opt_state_specs(opt_state: AdamState, params, sizes: Mapping[str, int],
                    rules: ShardingRules) -> AdamState:
    """ZeRO-1: the fp32 master and both moments shard like the params
    plus the fsdp axes (:func:`zero1_extend`); the step is replicated."""
    state = _map_with_path(
        lambda path, leaf: zero1_extend(
            param_spec(path, tuple(leaf.shape), sizes, rules),
            tuple(leaf.shape), sizes, rules), params)
    return AdamState(step=(), mu=state, nu=state,
                     master=state if opt_state.master is not None else None)


# ---------------------------------------------------------------------------
# batches and decode caches
# ---------------------------------------------------------------------------

def batch_specs(specs: Mapping[str, Any], sizes: Mapping[str, int],
                rules: ShardingRules) -> Dict[str, Spec]:
    """Each model input's spec (``specs``: name -> anything with a
    ``shape``, e.g. :func:`repro_torch.models.model.input_specs`): the
    batch over ``rules.batch``, or, where the batch cannot shard (B =
    1), the sequence."""
    out = {}
    for k, s in specs.items():
        shape = tuple(s.shape)
        ax = _fit(sizes, shape[0], rules.batch)
        spec = [ax] + [None] * (len(shape) - 1)
        if ax is None and len(shape) >= 2:
            spec[1] = _fit(sizes, shape[1], rules.batch)
        out[k] = tuple(spec)
    return out


def cache_specs(cache, sizes: Mapping[str, int], rules: ShardingRules,
                batch: int):
    """A tree like the decode ``cache`` holding each leaf's spec:
    context parallelism.  KV tensors (B, S, ...) shard the batch over
    ("pod", "data") and the sequence over "model" (and the data axes
    when B = 1); RG-LRU states shard their lanes and RWKV states their
    heads (or, for the token shifts, lanes) over ``rules.heads``."""
    batch_ax = _fit(sizes, batch, rules.batch)
    seq_axes = ("model",) if batch_ax is not None \
        else ("model", "pod", "data")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        d = len(shape)
        spec = [None] * d
        off = 1 if path.startswith("cycles/") else 0
        name = path.rsplit("/", 1)[-1]
        if name == "pos" or d - off == 0:
            return ()
        if shape[off] == batch and batch_ax is not None:
            spec[off] = batch_ax
        if name in ("k", "v", "c", "kr", "kv_pos"):
            spec[off + 1] = _fit(sizes, shape[off + 1], seq_axes)
        elif name == "S" and d - off == 4:           # RWKV (B, H, K, V)
            spec[off + 1] = _fit(sizes, shape[off + 1], rules.heads)
        elif name in ("h", "conv", "shift_t", "shift_c"):
            spec[d - 1] = _fit(sizes, shape[-1], rules.heads)
        return tuple(spec)

    return _map_with_path(one, cache)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a live ``DeviceMesh``: for each
    mesh dimension, ``Shard(i)`` where tensor dim i's entry names it,
    else ``Replicate()``.  A tensor dim over several mesh axes is
    major in the entry's first axis, as a ``PartitionSpec``'s; DTensor
    nests its shards in the mesh's axis order, so an entry whose axes
    are in another order (``("data", "pod")`` on a (pod, data, ...)
    mesh) raises, as does an axis the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of = {}
    for i, entry in enumerate(spec):
        axes = _spec_axes(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec entry {entry!r} names axes {missing} "
                             f"that the mesh {names} lacks")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(
                f"spec entry {entry!r} is major in {axes[0]!r}, but "
                f"DTensor nests a dim's shards in the mesh's axis order "
                f"{names}: no placement gives that layout")
        for name in axes:
            dim_of[name] = i
    return [Shard(dim_of[name]) if name in dim_of else Replicate()
            for name in mesh.mesh_dim_names]
