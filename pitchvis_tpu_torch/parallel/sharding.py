"""Scale-out over several devices.

Port of ``pitchvis_tpu/parallel/sharding.py``. The reference is single-host;
its only concurrency is an audio thread feeding a mutex-protected ring
buffer (pitchvis_audio/src/lib.rs:17-28). The scaling mechanism is batch
parallelism over independent audio streams: the stream axis is split into
contiguous row slices, one slice per mesh device, and the weights (the VQT
arrays, the ML model) are replicated. No stream depends on another, so the
serving hop calls no collective.

The JAX package's two levels are kept:

* one process drives every local device (``StreamServer(mesh=)``,
  :func:`make_sharded_pipeline_step`), the counterpart of ``shard_map`` over
  a single-controller ``Mesh``: the host thread enqueues each slice's work
  on that slice's device in turn (:func:`map_shards`);
* one process per host (runtime/multihost_serve.py), started through
  ``torch.distributed`` (:func:`make_multihost_mesh`), which carries
  nothing but start-up and the bench line's one gather.

A :class:`Mesh` is a grid of indexed devices (``cuda:1``, never a bare
``cuda``) with axis names. A device may repeat: torch has one CPU device, so
``make_mesh(n, device="cpu")`` makes n virtual CPU slots, the counterpart of
XLA's ``--xla_force_host_platform_device_count``; a GPU repeats only when
the caller lists it so (``Mesh([cuda:0, cuda:0])``), never by
:func:`make_mesh`. A value split by rows is a :class:`Sharded` (per-slot
tensors in row order), a replicated one a :class:`Replicated` (one copy a
distinct device); the output of a sharded step stays sharded, and nothing
is gathered inside a hop.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import operator

import numpy as np
import torch

from ..core.device import resolve_device


class Mesh:
    """Indexed devices on a grid with one name an axis.

    On several hosts (``n_processes > 1``) the leading axis is the hosts
    axis, row h holds host h's devices under their names on that host, and
    this process drives row ``process_index`` (:attr:`local_devices`).
    Devices are resolved on construction: a CUDA device raises without
    CUDA, and a bare ``cuda`` takes the current device's index."""

    def __init__(self, devices, axis_names=("dp",), *, process_index: int = 0, n_processes: int = 1):
        grid = np.asarray(devices, dtype=object)
        flat = [resolve_device(d) for d in grid.ravel()]
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a {self.devices.ndim}-d device grid")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        if n_processes > 1 and self.devices.shape[0] != n_processes:
            raise ValueError(f"a mesh over {n_processes} processes needs them on its leading axis")
        if not 0 <= process_index < n_processes:
            raise ValueError(f"process_index {process_index} outside [0, {n_processes})")
        self.process_index = process_index
        self.n_processes = n_processes

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_devices(self) -> tuple:
        """The devices this process drives, in slot order."""
        local = self.devices if self.n_processes == 1 else self.devices[self.process_index]
        return tuple(local.ravel())

    @property
    def local_offset(self) -> int:
        """The flat index of this process's first slot."""
        return 0 if self.n_processes == 1 else self.process_index * len(self.local_devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device="cuda") -> Mesh:
    """A one-axis mesh of ``n_devices`` (default: every GPU). On the card
    the devices are ``cuda:0 .. n-1``, and asking for more than
    ``torch.cuda.device_count()`` raises; with ``device="cpu"`` they are n
    virtual CPU slots (default 1)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices), (axis_name,))
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} GPUs on a host with {count}; list a repeated device in Mesh() for virtual slots")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


def make_multihost_mesh(axis_name: str = "dp", dcn_axis: str = "hosts", n_devices: int | None = None,
                        device="cuda") -> Mesh:
    """A (``dcn_axis``, ``axis_name``) grid with one row a process: rank and
    world size from ``torch.distributed`` (initialize its process group
    first, one process a host), this process's row the devices of
    ``make_mesh(n_devices, device=device)``. Streams split over both axes
    (the layout only decides which host feeds which streams); weights stay
    replicated, so no collective ever crosses hosts in serving. Without a
    process group this is a (1, n) grid and behaves like :func:`make_mesh`."""
    dist = torch.distributed
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_available() and dist.is_initialized() else (0, 1)
    row = list(make_mesh(n_devices, device=device).local_devices)
    return Mesh([row] * world, (dcn_axis, axis_name), process_index=rank, n_processes=world)


# ---------------------------------------------------------------------------
# sharded and replicated values
# ---------------------------------------------------------------------------


class Sharded:
    """A tensor split into pieces along ``axis`` (the stream axis), each
    piece on its own device, in row order: the counterpart of a JAX array
    with a stream sharding. ``devices`` names each piece's device (the
    counterpart of ``sharding.device_set``, one entry a piece), ``shape``
    the global shape. ``numpy()`` / ``np.asarray`` gather the rows to the
    host; on a mesh over several processes only this process's rows are
    here (``global_rows`` counts all), and gathering raises."""

    __slots__ = ("shards", "axis", "global_rows")

    def __init__(self, shards, axis: int = 0, global_rows: int | None = None):
        self.shards = tuple(shards)
        if not self.shards:
            raise ValueError("a sharded value needs at least one piece")
        self.axis = axis
        local = sum(s.shape[axis] for s in self.shards)
        self.global_rows = local if global_rows is None else global_rows

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        shape[self.axis] = self.global_rows
        return tuple(shape)

    @property
    def fully_addressable(self) -> bool:
        return sum(s.shape[self.axis] for s in self.shards) == self.global_rows

    def piece_rows(self) -> list[int]:
        return [s.shape[self.axis] for s in self.shards]

    def locate(self, row: int) -> tuple[int, int]:
        """(piece, row within it) of a row of this process's pieces."""
        if row < 0:
            row += self.global_rows
        for i, n in enumerate(self.piece_rows()):
            if row < n:
                return i, row
            row -= n
        raise IndexError("row outside the sharded value's local rows")

    def replace(self, i: int, piece: torch.Tensor) -> "Sharded":
        shards = list(self.shards)
        shards[i] = piece
        return Sharded(shards, self.axis, self.global_rows)

    def cpu(self) -> torch.Tensor:
        """The global value as one host tensor."""
        if not self.fully_addressable:
            raise RuntimeError("the sharded value spans other processes; gather their rows first")
        return torch.cat([s.detach().cpu() for s in self.shards], dim=self.axis)

    def numpy(self) -> np.ndarray:
        t = self.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, i: int):
        """An integer index: on the stream axis (``axis == 0``) that row, a
        tensor on its piece's device; on a leading axis (``axis > 0``, the
        hop axis of a (K, B, ...) block) a Sharded of that hop's rows."""
        try:
            i = operator.index(i)
        except TypeError:
            raise TypeError("a sharded value takes integer indices; gather it with .cpu() for more") from None
        if self.axis == 0:
            piece, row = self.locate(i)
            return self.shards[piece][row]
        return Sharded([s[i] for s in self.shards], self.axis - 1, self.global_rows)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, axis={self.axis}, devices={[str(d) for d in self.devices]})"


class Replicated:
    """One copy of a value (a tensor, a tree of them, a module, a plan) on
    each distinct device of a mesh's slots. ``devices`` names the slots'
    devices in order; slots that share a device share its copy."""

    __slots__ = ("devices", "_copies")

    def __init__(self, devices, copies: dict):
        self.devices = tuple(devices)
        self._copies = dict(copies)

    @classmethod
    def build(cls, devices, make) -> "Replicated":
        """``make(device)`` once a distinct device."""
        devices = tuple(devices)
        return cls(devices, {d: make(d) for d in dict.fromkeys(devices)})

    def on(self, device: torch.device):
        return self._copies[device]

    def __repr__(self) -> str:
        return f"Replicated(devices={[str(d) for d in self.devices]})"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Sharded, Replicated))


def tree_map(fn, tree, *rest):
    """``fn`` on each leaf (a tensor, Sharded or Replicated) of ``tree``, a
    nest of tuples, lists, dicts and dataclasses, zipped with the same
    structure in ``rest``; other values (None, ints, modules) pass as they
    are. A dataclass is copied field by field, ``init=False`` fields
    included."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        new = [tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest)) for n in names]
        if all(v is getattr(tree, n) for n, v in zip(names, new)):
            return tree  # no leaf below (a parameter set): kept as it is
        out = copy.copy(tree)
        for n, v in zip(names, new):
            object.__setattr__(out, n, v)
        return out
    return tree


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(lambda x: leaves.append(x), tree)
    return leaves


def device_scope(device: torch.device):
    """The CUDA device context of ``device`` (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def join(pieces: list, axis=0, span: int = 1):
    """Per-piece trees of one structure -> one tree of Sharded leaves (a
    leaf of the first tree that is not a tensor is kept). ``axis`` is the
    stream axis of every leaf, or a tuple of axes, one for each top-level
    element of a tuple tree. ``span``: the global rows over the local ones
    (the process count on a multi-host mesh)."""
    if isinstance(axis, tuple):
        return tuple(join([p[i] for p in pieces], a, span) for i, a in enumerate(axis))

    def one(first, *rest):
        if isinstance(first, torch.Tensor):
            return Sharded((first, *rest), axis, span * sum(t.shape[axis] for t in (first, *rest)))
        return first

    return tree_map(one, pieces[0], *pieces[1:])


def piece(tree, i: int, device: torch.device | None = None):
    """Piece ``i`` of every Sharded leaf of ``tree``; a Replicated leaf
    gives its copy on ``device``."""

    def one(x):
        if isinstance(x, Sharded):
            return x.shards[i]
        if isinstance(x, Replicated):
            return x.on(device)
        return x

    return tree_map(one, tree)


def with_piece(tree, i: int, new):
    """``tree`` with piece ``i`` of each Sharded leaf replaced by the
    matching leaf of ``new`` (a tree of one piece; functional)."""
    return tree_map(lambda s, n: s.replace(i, n) if isinstance(s, Sharded) else s, tree, new)


def map_shards(fn, *args, out_axis=0, **kwargs):
    """Runs ``fn`` once a piece, on that piece's device, and joins the
    results: the counterpart of ``shard_map``. Every Sharded leaf of
    ``args``/``kwargs`` gives its piece (all have the same pieces), every
    Replicated leaf its copy on the piece's device; other values pass as
    they are. One host thread enqueues the pieces in turn, each inside its
    device's context. ``out_axis`` as in :func:`join`; the results span
    the processes the sharded arguments span."""
    sharded = [x for x in tree_leaves((args, kwargs)) if isinstance(x, Sharded)]
    if not sharded:
        raise ValueError("map_shards needs a sharded argument")
    devices = sharded[0].devices
    rows = sharded[0].piece_rows()
    for x in sharded[1:]:
        if x.devices != devices or x.piece_rows() != rows:
            raise ValueError(f"sharded arguments split differently: {x} against {sharded[0]}")
    outs = []
    for i, dev in enumerate(devices):
        with device_scope(dev):
            outs.append(fn(*piece(args, i, dev), **piece(kwargs, i, dev)))
    return join(outs, out_axis, sharded[0].global_rows // sum(rows))


def gather(tree):
    """Every Sharded leaf as one host tensor (the other leaves as they
    are): for saving and inspection, never on a hop's path."""
    return tree_map(lambda x: x.cpu() if isinstance(x, Sharded) else x, tree)


def select_rows(tree, rows):
    """Rows ``rows`` (ints, in the order given) of every Sharded leaf of
    ``tree`` (the leaves split alike): each run of consecutive rows from one
    piece becomes one piece of the result, on that device. A run of
    ascending neighbours is a view; any other run is indexed by a tensor
    copied to its device."""
    first = next(x for x in tree_leaves(tree) if isinstance(x, Sharded))
    runs = []  # (piece, [local rows])
    for r in rows:
        p, local = first.locate(int(r))
        if runs and runs[-1][0] == p:
            runs[-1][1].append(local)
        else:
            runs.append((p, [local]))
    index = []
    for p, local in runs:
        if local == list(range(local[0], local[0] + len(local))):
            index.append((p, slice(local[0], local[0] + len(local))))
        else:
            index.append((p, torch.as_tensor(local, dtype=torch.int64).to(first.shards[p].device)))

    def one(x):
        if not isinstance(x, Sharded):
            return x
        return Sharded([x.shards[p][idx] for p, idx in index], x.axis)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamSharding:
    """The stream axis (``dim`` of each array) split into contiguous row
    slices, one slice a mesh slot, over every mesh axis in row-major slot
    order: the counterpart of ``NamedSharding(mesh, P(axes))``."""

    mesh: Mesh
    dim: int = 0

    def bounds(self, n_rows: int) -> list[tuple[int, int]]:
        """(start, stop) of every slot's slice of ``n_rows`` global rows."""
        if n_rows % self.mesh.size:
            raise ValueError(f"{n_rows} rows do not split evenly over the {self.mesh.size}-slot mesh")
        per = n_rows // self.mesh.size
        return [(k * per, (k + 1) * per) for k in range(self.mesh.size)]

    def local_slices(self, n_rows: int) -> list[tuple[torch.device, int, int]]:
        """(device, start, stop) of this process's slots, in global rows."""
        bounds = self.bounds(n_rows)
        off = self.mesh.local_offset
        return [(d, *bounds[off + k]) for k, d in enumerate(self.mesh.local_devices)]

    def put(self, x) -> Sharded:
        """A host array or a tensor of the global rows (or a tree of them)
        -> the local slices on their devices (each slice copied once to its
        device)."""
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return tree_map(self.put, x)
        t = torch.as_tensor(x)
        pieces = [t.narrow(self.dim, a, b - a).to(d) for d, a, b in self.local_slices(t.shape[self.dim])]
        return Sharded(pieces, self.dim, t.shape[self.dim])

    def put_local(self, x) -> Sharded:
        """This process's rows only (on one host all of them) -> its slots:
        the counterpart of ``jax.make_array_from_process_local_data``."""
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return tree_map(self.put_local, x)
        t = torch.as_tensor(x)
        n_local = len(self.mesh.local_devices)
        if t.shape[self.dim] % n_local:
            raise ValueError(f"{t.shape[self.dim]} local rows do not split over {n_local} local slots")
        per = t.shape[self.dim] // n_local
        pieces = [t.narrow(self.dim, k * per, per).to(d) for k, d in enumerate(self.mesh.local_devices)]
        return Sharded(pieces, self.dim, per * self.mesh.size)


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """A copy on every slot's device (``NamedSharding(mesh, P())``)."""

    mesh: Mesh

    def put(self, tree) -> Replicated:
        def to(device):
            def leaf(x):
                return x.to(device) if isinstance(x, torch.Tensor) else x

            if isinstance(tree, torch.nn.Module):
                return tree if _module_device(tree) == device else copy.deepcopy(tree).to(device)
            return tree_map(leaf, tree)

        return Replicated.build(self.mesh.local_devices, to)


def _module_device(module: torch.nn.Module):
    p = next(module.parameters(), None)
    return p.device if p is not None else None


def _check_axes(mesh: Mesh, axis_name) -> None:
    if axis_name is None:
        return
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if names != mesh.axis_names:
        raise ValueError(f"streams split over every mesh axis {mesh.axis_names}, not {names}")


def stream_sharding(mesh: Mesh, axis_name=None, dim: int = 0) -> StreamSharding:
    """The stream axis split over every mesh axis; ``axis_name``, if given,
    must name them all (a custom name of a one-axis mesh, say)."""
    _check_axes(mesh, axis_name)
    return StreamSharding(mesh, dim)


def multihost_stream_sharding(mesh: Mesh) -> StreamSharding:
    """The stream axis split over hosts x devices: the multi-host name of
    :func:`stream_sharding`'s default (one rule, two entry points)."""
    return stream_sharding(mesh)


def replicated(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


def shard_batch(mesh: Mesh, x, axis_name=None, dim: int = 0):
    """Places a host batch (an array, a tensor, or a tree of them) on the
    mesh, stream axis split; each slot receives only its slice."""
    return stream_sharding(mesh, axis_name, dim).put(x)


def replicate(mesh: Mesh, tree) -> Replicated:
    """A copy of ``tree`` (e.g. the VQT arrays, or a module) on every
    distinct device of the mesh."""
    return replicated(mesh).put(tree)


# ---------------------------------------------------------------------------
# the sharded serving step
# ---------------------------------------------------------------------------


def make_sharded_pipeline_step(mesh: Mesh, *, multi: bool = False, **static_kwargs):
    """The multi-device serving step: ``pipeline_step`` run on each stream
    slice, on that slice's device, with the VQT arrays replicated: the
    counterpart of the JAX package's ``shard_map`` boundary. Each slot runs
    the whole hop (ring push and AGC kernel, fused VQT kernel, two peaks
    launches) on its own rows; streams are independent, so the step calls
    no collective.

    ``multi=True`` runs ``pipeline_step_multi`` instead: chunks and outputs
    gain a leading hop axis K that is not split. ``static_kwargs`` are the
    pipeline's statics (``vqt_params=``, ``path=``, ...; a Replicated value,
    such as a replicated ``ml_model``, gives each slot its device's copy).
    Returns ``step(arrays, state, chunk, dt) -> (state, outputs)``:
    ``arrays`` from :func:`replicate`, ``state`` and ``chunk`` from
    :func:`shard_batch` (chunk (K, B, hop) with ``dim=1`` when ``multi``),
    ``dt`` a scalar or per-stream (B,) seconds, split with the batch."""
    from ..models.pipeline import pipeline_step, pipeline_step_multi

    base = pipeline_step_multi if multi else pipeline_step
    rows = stream_sharding(mesh)

    def step(arrays, state, chunk, dt):
        if not isinstance(dt, (Sharded, float, int)) and np.ndim(dt) > 0:
            dt = rows.put(dt)  # a per-stream dt splits with the batch
        return map_shards(base, arrays, state, chunk, dt, out_axis=(0, 1 if multi else 0), **static_kwargs)

    return step


# the point-to-point and collective calls of torch.distributed
COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
    "reduce", "gather", "gather_object", "scatter", "scatter_object_list", "barrier", "monitored_barrier",
    "send", "recv", "isend", "irecv", "batch_isend_irecv",
)


@contextlib.contextmanager
def no_collectives():
    """Within the block every collective of ``torch.distributed`` raises
    RuntimeError naming itself: the serving hop's start-up check (the JAX
    package scans the compiled program's text for collectives instead). It
    patches the module's functions, so it sees calls made through
    ``torch.distributed.<name>``; use it around a probe hop, with no other
    thread calling collectives."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    def refuse(name):
        def call(*args, **kwargs):
            raise RuntimeError(f"collective {name} in the serving hot path")

        return call

    saved = [(mod, name, getattr(mod, name)) for mod in (dist, c10d) for name in COLLECTIVES if hasattr(mod, name)]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, refuse(name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
