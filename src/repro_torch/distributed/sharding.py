"""Logical-axis sharding rules -> DTensor placements (PyTorch twin of
``src/repro/distributed/sharding.py``).

Model code names a logical axis for every dimension of every param and
cache leaf (``Model.param_axes`` / ``cache_axes``), right-aligned against
the leaf's shape: a stacked leading dimension (the caches' layers or
sites) is left unnamed and replicated.  ``ShardingRules`` maps logical
names to mesh axes; ``spec_for`` applies the map with the reference's
divisibility guard: a logical axis whose dimension does not divide the
mesh axis size is REPLICATED instead (GSPMD rejects uneven input
shardings) and reported in ``dropped``, so the dry run can see what was
dropped.  A spec is the reference's ``PartitionSpec`` as a tuple: one
entry per tensor dimension, ``None``, a mesh axis name, or a tuple of
names.  ``placements`` turns a spec into one DTensor placement per mesh
dimension, and ``distribute`` places a tree of tensors with
``distribute_tensor``.

A mesh here is anything whose ``shape`` maps axis names to sizes (the
reference's tests pass a ``SimpleNamespace``), or a ``DeviceMesh`` with
``mesh_dim_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

from torch.distributed.tensor import (Placement, Replicate, Shard,
                                      distribute_tensor)

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]


# default rules: TP over "model", DP over ("pod","data") for batch
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "vocab": "model",
    "embed": None,
    "embed_in": None,
    "ff": "model",
    "moe_ff": None,
    "heads_x_dim": "model",
    "kv_heads_x_dim": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    # data-side axes
    "batch": ("pod", "data"),
    "kv_heads": None,
    "kv_seq": "model",
}


def mesh_sizes(mesh) -> Mapping[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``mesh_dim_names`` against its
    shape, else ``mesh.shape`` as the reference reads it."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


@dataclasses.dataclass
class ShardingRules:
    rules: Dict[str, MeshAxes]
    dropped: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def default(overrides: Optional[Dict[str, MeshAxes]] = None
                ) -> "ShardingRules":
        r = dict(DEFAULT_RULES)
        if overrides:
            r.update(overrides)
        return ShardingRules(r)

    def spec_for(self, mesh, shape: Tuple[int, ...],
                 logical: Tuple[Optional[str], ...],
                 leaf_name: str = "") -> Spec:
        """Right-align ``logical`` against ``shape``; drop non-divisible."""
        sizes = mesh_sizes(mesh)
        ndim = len(shape)
        pad = ndim - len(logical)
        if pad < 0:
            raise ValueError(f"{leaf_name}: {len(logical)} logical axes "
                             f"{logical} for shape {tuple(shape)}")
        full = (None,) * pad + tuple(logical)
        entries: List[MeshAxes] = []
        for dim, name in zip(shape, full):
            axes = self.rules.get(name) if name is not None else None
            if axes is None:
                entries.append(None)
                continue
            axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
            # mesh may not have all axes (single-pod has no "pod")
            axes_t = tuple(a for a in axes_t if a in sizes)
            size = 1
            for a in axes_t:
                size *= sizes[a]
            if not axes_t:
                entries.append(None)
            elif dim % size != 0:
                self.dropped.append(f"{leaf_name}:{name}({dim}%{size})")
                entries.append(None)
            else:
                entries.append(axes_t[0] if len(axes_t) == 1 else axes_t)
        # a mesh axis shards one tensor dimension only: keep the first
        used: set = set()
        cleaned: List[MeshAxes] = []
        for e in entries:
            if e is None:
                cleaned.append(None)
                continue
            et = (e,) if isinstance(e, str) else tuple(e)
            et = tuple(a for a in et if a not in used)
            used.update(et)
            if not et:
                cleaned.append(None)
            else:
                cleaned.append(et[0] if len(et) == 1 else et)
        return tuple(cleaned)


def placements(mesh, spec: Spec) -> Tuple[Placement, ...]:
    """One placement per dimension of ``mesh`` (a ``DeviceMesh``): Shard(d)
    on every mesh axis that ``spec`` gives tensor dimension d, Replicate()
    on the rest.  A tuple entry such as ("pod", "data") splits its
    dimension over both axes, the outer first, as GSPMD does; its axes
    must stand in the mesh's order.  An axis of size 1 holds the whole
    dimension, so it replicates (DTensor would track a one-way shard
    through every view and refuse some)."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: List[Placement] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} against mesh axes {names}: "
                             f"the outer axis must come first")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------------------
# trees: nested dicts and lists, the port's params and caches
# ---------------------------------------------------------------------------

def _shape(leaf) -> Tuple[int, ...]:
    """A tensor's shape, or the shape of a ``batch_struct`` entry
    ``(shape, dtype)``."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def map_leaves(fn: Callable, tree, *others, path: str = ""):
    """``fn(path, leaf, *other_leaves)`` over the leaves of ``tree``
    (nested dicts and lists; anything else is a leaf), zipped with the
    same-structured ``others``, in ``tree``'s structure.  An axes tree's
    tuples are leaves."""
    if isinstance(tree, Mapping):
        if any(set(o) != set(tree) for o in others):
            raise ValueError(f"{path or '/'}: the trees' keys differ")
        return {k: map_leaves(fn, v, *(o[k] for o in others),
                              path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        if any(len(o) != len(tree) for o in others):
            raise ValueError(f"{path or '/'}: the trees' lengths differ")
        return [map_leaves(fn, v, *(o[i] for o in others),
                           path=f"{path}/{i}")
                for i, v in enumerate(tree)]
    return fn(path, tree, *others)


def spec_tree(mesh, struct_tree, axes_tree, rules: ShardingRules):
    """``struct_tree`` (tensors, meta or fake tensors, or ``(shape, dtype)``
    pairs) with each leaf's spec in its place."""
    return map_leaves(lambda path, leaf, ax: rules.spec_for(
        mesh, _shape(leaf), ax, path), struct_tree, axes_tree)


def build_shardings(mesh, struct_tree, axes_tree, rules: ShardingRules):
    """The placements of every leaf of ``struct_tree`` on ``mesh`` (a
    ``DeviceMesh``), in its structure: the reference's tree of
    ``NamedSharding``."""
    return map_leaves(lambda _, spec: placements(mesh, spec),
                      spec_tree(mesh, struct_tree, axes_tree, rules))


def batch_axes_tree(batch_struct: Dict[str, Any]) -> Dict[str, Tuple]:
    """Data inputs: shard axis 0 (batch) over ("pod","data")."""
    return {k: ("batch",) + (None,) * (len(_shape(v)) - 1)
            for k, v in batch_struct.items()}


def replicated(mesh, tree):
    """Every leaf replicated on ``mesh``."""
    return map_leaves(lambda *_: (Replicate(),) * mesh.ndim, tree)


def distribute(mesh, tree, placements_tree):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the placements
    at its place in ``placements_tree``."""
    return map_leaves(lambda _, t, pl: distribute_tensor(t, mesh, list(pl)),
                      tree, placements_tree)

