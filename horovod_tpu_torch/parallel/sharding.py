"""Logical-axis sharding rules, and shards of tensors on a rank mesh.

The port of ``horovod_tpu/parallel/sharding.py``.  Every tensor dimension
gets a logical name (``batch``, ``seq``, ``embed``, ``mlp``, ``heads``,
``experts``, ``stage``...), and one table maps the logical names to mesh
axes, so models never name mesh axes themselves.

The rules are kept as data, entry for entry the reference's: a spec is a
tuple with one entry a tensor dimension, each entry ``None``
(replicated), an axis name, or a tuple of axis names, in place of
``PartitionSpec``.  A dimension mapped to several axes splits major to
minor in the tuple's order: under ``("tp", "fsdp")`` the ``tp`` index
picks the major block and ``fsdp`` the block within it, whatever the
axes' order in the mesh.

Where the reference hands a ``NamedSharding`` to XLA, which then places
and moves the data, a process here holds one rank's block of each tensor:

- :func:`shard` gives this rank's block of a full tensor under a spec on
  a :func:`~.mesh.build_mesh` mesh (:func:`block` for any coordinate,
  with no process group);
- :func:`unshard`, its inverse, gathers the blocks back to the full
  tensor (collective over the spec's axes);
- :func:`constrain` reshards a local block from one spec to another, and
  does nothing when every axis the two specs name has size 1 (the
  reference's rule: the constraint is then no sharding at all).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Entry = Union[None, str, tuple]

# logical dimension name -> mesh axis (or tuple of axes) it shards over
DEFAULT_RULES: dict[str, Union[None, str, tuple[str, ...]]] = {
    "batch": ("dp", "fsdp"),   # data-parallel batch split
    "seq": "sp",               # sequence/context parallel
    "embed": "fsdp",           # ZeRO-3: params sharded over fsdp at rest
    "mlp": "tp",               # column-parallel hidden dim
    "heads": "tp",             # attention heads over tp
    "kv_heads": "tp",
    "head_dim": None,
    "qkv": None,
    "vocab": "tp",             # output projection vocab-parallel
    # Embedding-table rows: the table is sharded on its vocab (indexed)
    # dim, so a lookup is one masked local lookup a shard and a sum.
    "vocab_rows": ("tp", "fsdp"),
    "experts": "ep",           # MoE experts over ep
    "expert_mlp": "tp",
    "stage": "pp",             # pipeline stage dimension (stacked params)
    "norm": None,
}


def spec_for(logical_dims: Sequence[Optional[str]],
             rules: Optional[dict] = None) -> tuple:
    """The spec of a tensor whose dims have these logical names."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    entries = []
    for dim in logical_dims:
        if dim is None:
            entries.append(None)
            continue
        if dim not in rules:
            raise KeyError(f"unknown logical dim {dim!r}")
        entries.append(rules[dim])
    return tuple(entries)


def axis_sizes(mesh) -> dict:
    """Axis name -> size of ``mesh``: a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``), a ``MeshConfig`` or a dict."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "axis_sizes"):
        return mesh.axis_sizes()
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    raise TypeError(f"not a mesh: {type(mesh).__name__} (expected a "
                    f"DeviceMesh from parallel.build_mesh)")


def fitted_rules(mesh, dim_sizes: dict[str, int],
                 rules: Optional[dict] = None) -> dict:
    """Mesh-aware rule overrides: for each logical dim in ``dim_sizes``,
    keep the longest prefix of its mapped mesh axes whose product divides
    the dim size, degrading to replication when even the first axis does
    not divide (e.g. ``kv_heads=2`` on a ``tp=4`` mesh).  Returns an
    override dict to pass as ``rules`` to :func:`spec_for`."""
    sizes = axis_sizes(mesh)
    base = {**DEFAULT_RULES, **(rules or {})}
    out = dict(rules or {})
    for dim, size in dim_sizes.items():
        axes = base.get(dim)
        if axes is None:
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        kept: list[str] = []
        prod = 1
        for a in axes_t:
            n = sizes.get(a, 1)
            if n > 1 and size % (prod * n) != 0:
                break
            kept.append(a)
            prod *= n
        if len(kept) != len(axes_t):
            out[dim] = tuple(kept) if kept else None
    return out


def entry_axes(entry: Entry) -> tuple:
    """The axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Sequence[Entry]) -> set:
    """The set of mesh axis names a spec references."""
    out = set()
    for entry in spec:
        out.update(entry_axes(entry))
    return out


def coordinate(mesh) -> dict:
    """This rank's index along every axis of ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def _split(entry: Entry, sizes: dict, coord: dict) -> tuple[int, int]:
    """(index of the block, number of blocks) of one dim: the axes of the
    entry split major to minor in the entry's order."""
    idx, count = 0, 1
    for a in entry_axes(entry):
        n = sizes.get(a, 1)
        idx = idx * n + coord.get(a, 0)
        count *= n
    return idx, count


def block_slices(shape: Sequence[int], spec: Sequence[Entry], sizes: dict,
                 coord: dict) -> tuple:
    """The slices of ``shape`` that the rank at ``coord`` holds."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{len(shape)}-d tensor")
    out = []
    for d, (size, entry) in enumerate(zip(shape, spec)):
        idx, count = _split(entry, sizes, coord)
        if size % count:
            raise ValueError(
                f"dim {d} of size {size} does not split over "
                f"{entry_axes(entry)} ({count} blocks)")
        step = size // count
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def block(x, spec: Sequence[Entry], sizes: dict, coord: dict):
    """The block of ``x`` (a tensor or a numpy array) that the rank at
    ``coord`` of a mesh with axis ``sizes`` holds under ``spec``: a view."""
    return x[block_slices(x.shape, spec, sizes, coord)]


def is_trivial(spec: Sequence[Entry], mesh) -> bool:
    """Whether every axis ``spec`` names has size 1 on ``mesh``."""
    sizes = axis_sizes(mesh)
    return all(sizes.get(a, 1) == 1 for a in spec_axes(spec))


def shard(x: torch.Tensor, spec: Sequence[Entry], mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: ``x``
    itself when the spec names no axis of size > 1, else a contiguous
    copy (so the full tensor's storage is not kept)."""
    if mesh is None or is_trivial(spec, mesh):
        return x
    return block(x, spec, axis_sizes(mesh), coordinate(mesh)).clone(
        memory_format=torch.contiguous_format)


def unshard(x, spec: Sequence[Entry], mesh):
    """The full tensor from every rank's block ``x`` under ``spec``, the
    inverse of :func:`shard`: along each sharded dim, an all-gather over
    its axes, the minor axis first.  Collective over those axes (every
    rank of each group calls it); no gradient flows through it."""
    from . import comm
    if mesh is None or is_trivial(spec, mesh):
        return x
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            x = comm.gather_tensor(x, mesh, (a,), d)
    return x


def constrain(x, logical_dims: Sequence[Optional[str]], mesh=None,
              rules: Optional[dict] = None, *,
              current: Optional[Sequence[Optional[str]]] = None):
    """Reshard this rank's block ``x`` from the spec of ``current`` (the
    logical dims it is sharded by now; default: not sharded, ``x`` is the
    full tensor) to the spec of ``logical_dims``.  Nothing happens when
    every axis the two specs name has size 1, or when they are the same.

    Differentiable: the gather is an all-gather whose backward
    reduce-scatters, the slice's backward pads with zeros, so a rank's
    gradient of a replicated result is its share of the total (the
    gradients of the ranks holding copies sum to it)."""
    from . import comm
    src = spec_for(current if current is not None
                   else (None,) * x.dim(), rules)
    dst = spec_for(logical_dims, rules)
    if mesh is None or src == dst or (is_trivial(src, mesh)
                                      and is_trivial(dst, mesh)):
        return x
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(src):
        for a in reversed(entry_axes(entry)):
            x = comm.all_gather(x, mesh, (a,), d)
    sl = block_slices(x.shape, dst, sizes, coordinate(mesh))
    return x[sl]
