"""Device mesh for the ring pair evaluator and the sharded step.

Counterpart of `skellysim_tpu.parallel.mesh` (`FIBER_AXIS`, `MEMBER_AXIS`,
`make_mesh`, `make_member_mesh`, `make_2d_mesh`, `shard_ensemble`,
`SHELL_ROW_SHARDED_FIELDS`, `shard_state`). The port keeps the JAX
package's single-controller model: a mesh is an ordered tuple of shard
devices in one process. On several cards each card holds one shard; on one
card (or on the CPU, as the tests run it) one device holds several shards,
the analogue of the JAX tests' forced host devices. The ring kernels run
the same device code in both layouts (`ops.cuda_kernels`
`ring_stokeslet_f32` / `ring_stresslet_f32`).

A state placed on a mesh (`shard_state`) is a `ShardedState`: one local
`SimState` a shard, the layout of the JAX package's `shard_map` program
(`parallel.spmd`): each fiber bucket's block of whole fibers, the shell's
node-aligned row block (or the whole shell on every shard, where it cannot
split), and everything else replicated. `gather_state` is the only way
back to one device.

The ensemble's member meshes: `make_member_mesh` lays its shards along
`MEMBER_AXIS`, and `shard_ensemble` places B / D whole lanes of an
`ensemble.EnsembleState` on each shard (a `ShardedEnsemble`); the runner
steps each shard's lanes as one batched trial on its device, with no
collectives (`ensemble.runner.EnsembleRunner.step`). `make_2d_mesh` is the
(member, fiber) shape: each member group's fiber ring (`Mesh.fiber_group`)
is a mesh that `System.step_spmd` takes.

After `parallel.multihost.initialize` a mesh spans processes: every
process names every shard's device, process and card, in process order,
and holds only its own shards (`Mesh.local`): `shard_state` keeps them
(copies of their rows, so the whole state can be dropped), `gather_state`
all-gathers the shards to every process.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve_device

FIBER_AXIS = "fib"

#: the ensemble member (batch) axis: batch parallelism is the outer axis
MEMBER_AXIS = "member"

#: the shell fields that row-shard, by `PeripheryState` field name: the two
#: O(n_nodes^2) dense operators (the reference's Scatterv'd shell rows). A
#: sharded shell splits its O(n_nodes) fields node-aligned too, as the JAX
#: package's step does inside its program: each shard holds the rows of its
#: own nodes
SHELL_ROW_SHARDED_FIELDS = ("stresslet_plus_complementary", "M_inv")


@dataclass(frozen=True)
class Mesh:
    """Shards in a row, ``devices[k]`` holding shard k: by default a 1-D
    ring along `FIBER_AXIS`; a member mesh (`make_member_mesh`) lays them
    along `MEMBER_AXIS`; a 2-D mesh (`make_2d_mesh`) has ``axis_names``
    (MEMBER_AXIS, FIBER_AXIS) and ``grid`` (n_member, n_fiber), member
    major. A mesh that spans processes (`make_mesh` after
    `parallel.multihost.initialize`) also names shard k's process
    (``processes[k]``, in process order) and card (``cards[k]``,
    `multihost.card_id`), and this process's index (``process``)."""

    devices: tuple
    processes: tuple | None = None
    cards: tuple | None = None
    process: int = 0
    axis_names: tuple = (FIBER_AXIS,)
    grid: tuple | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (the JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.grid or (self.size,)))

    def fiber_group(self, i: int) -> "Mesh":
        """Member group ``i``'s fiber ring of a 2-D mesh: a 1-D
        `FIBER_AXIS` mesh of its ``n_fiber`` shards, which
        `System.step_spmd` takes."""
        if self.axis_names != (MEMBER_AXIS, FIBER_AXIS):
            raise ValueError("fiber_group needs a (member, fiber) mesh "
                             f"(make_2d_mesh); this one is {self.axis_names}")
        nf = self.grid[1]
        return Mesh(self.devices[i * nf:(i + 1) * nf])

    @property
    def spans_processes(self) -> bool:
        """Whether the shards lie in more than one process."""
        return self.processes is not None and len(set(self.processes)) > 1

    @property
    def local(self) -> range:
        """This process's shards: a run of consecutive indices (every
        shard in one process)."""
        if self.processes is None:
            return range(self.size)
        mine = [k for k, p in enumerate(self.processes) if p == self.process]
        return range(mine[0], mine[-1] + 1)

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[k] for k in self.local)

    def owner(self, k: int) -> int:
        """The process of shard ``k``."""
        return 0 if self.processes is None else self.processes[k]

    def shared_cards(self) -> list:
        """The cards that shards of more than one process lie on."""
        if self.processes is None:
            return []
        by_card = {}
        for card, p in zip(self.cards, self.processes):
            by_card.setdefault(card, set()).add(p)
        return sorted(c for c, ps in by_card.items() if len(ps) > 1)


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """A ring of ``n_devices`` shards.

    With ``device`` (e.g. ``"cpu"``, ``"cuda"`` or ``"cuda:1"``) all
    ``n_devices`` shards (default 1) live on that one device. Without it
    each shard gets its own card, the first ``n_devices`` visible ones
    (default: all), and every card is given access to its two ring
    neighbours' memory; asking for more cards than exist, or for cards that
    cannot reach their neighbours, raises.

    After `parallel.multihost.initialize` the mesh spans the processes, in
    process order: each process contributes ``n_devices`` shards (default
    1) of ``device``, or without ``device`` one shard on its own card (then
    ``n_devices``, if given, must be the process count). Every process
    must contribute as many shards. The layouts are exchanged once."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    from . import multihost

    if multihost.runtime() is not None:
        return _process_mesh(multihost, n_devices, device)
    if device is not None:
        dev = resolve_device(device)
        return Mesh((dev,) * (1 if n_devices is None else int(n_devices)))
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh() places one shard on each CUDA card and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for shards on the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n > count:
        raise ValueError(f"a mesh of {n} cards was asked for and {count} "
                         "are visible; pass device=... to place several "
                         "shards on one card")
    devices = tuple(torch.device("cuda", i) for i in range(n))
    if n > 1:
        from ..ops.cuda_kernels import enable_ring_peer_access

        enable_ring_peer_access(devices)
    return Mesh(devices)


def make_member_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards along `MEMBER_AXIS`
    (`shard_ensemble`), placed as `make_mesh` places its shards: all on
    ``device`` when it is given, else one a card (one a process after
    `parallel.multihost.initialize`)."""
    return dataclasses.replace(make_mesh(n_devices, device=device),
                               axis_names=(MEMBER_AXIS,))


def make_2d_mesh(n_member: int, n_fiber: int, *, device=None) -> Mesh:
    """The (member, fiber) mesh: ``n_member`` groups of ``n_fiber`` shards,
    member major, each group's fibers sharded over its own ring
    (`Mesh.fiber_group`). All shards on ``device`` when it is given, else
    one a card, the first ``n_member * n_fiber`` cards of this process,
    each group's cards given access to their ring neighbours."""
    need = n_member * n_fiber
    if device is not None:
        devices = (resolve_device(device),) * need
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise ValueError(
                f"2-D mesh {n_member}x{n_fiber} needs {need} devices, "
                f"have {have}")
        devices = tuple(torch.device("cuda", i) for i in range(need))
        if n_fiber > 1:
            from ..ops.cuda_kernels import enable_ring_peer_access

            for i in range(n_member):
                enable_ring_peer_access(
                    devices[i * n_fiber:(i + 1) * n_fiber])
    return Mesh(devices, axis_names=(MEMBER_AXIS, FIBER_AXIS),
                grid=(n_member, n_fiber))


class ShardedEnsemble(NamedTuple):
    """An `ensemble.EnsembleState` placed on a member mesh by
    `shard_ensemble`: ``parts[j]`` holds the lanes of the mesh's j-th
    local shard (``mesh.local``), its tensors on that shard's device."""

    parts: tuple
    mesh: Mesh

    @property
    def t_final(self):
        import numpy as np

        return np.concatenate([p.t_final for p in self.parts])


def _member_count(mesh: Mesh) -> int:
    if MEMBER_AXIS not in mesh.axis_names:
        raise ValueError("shard_ensemble needs a mesh with the member axis "
                         f"(make_member_mesh); this one is {mesh.axis_names}")
    return mesh.shape[MEMBER_AXIS]


def shard_ensemble(ens, mesh: Mesh) -> ShardedEnsemble:
    """Place an `ensemble.EnsembleState`'s lanes on a member mesh: each
    member shard gets B / D whole lanes (consecutive, in lane order) on
    its device, the first device of its group on a 2-D mesh. The runner
    steps each shard's lanes as one batched trial with no collectives;
    across processes each process holds and steps its own shards. B must
    be divisible by the member count."""
    from ..ensemble.runner import slice_lanes

    n = _member_count(mesh)
    B = len(ens.t_final)
    if B % n != 0:
        raise ValueError(
            f"ensemble batch B={B} is not divisible by the mesh size ({n}); "
            "pick B as a multiple of the device count (idle padding lanes "
            "are cheap: the scheduler masks them)")
    m = B // n
    per = mesh.size // n
    shards = [k for k in range(n) if k * per in mesh.local]
    return ShardedEnsemble(
        tuple(slice_lanes(ens, k * m, (k + 1) * m, mesh.devices[k * per])
              for k in shards), mesh)


def gather_ensemble(sharded: ShardedEnsemble, device=None):
    """The `ensemble.EnsembleState` of a `ShardedEnsemble`'s local shards
    on one ``device`` (default: the first shard's), lanes in order."""
    from ..ensemble.runner import concat_lanes

    return concat_lanes(list(sharded.parts),
                        None if device is None else resolve_device(device))


def _process_mesh(multihost, n_devices, device) -> Mesh:
    """`make_mesh` over the joined processes."""
    rt = multihost.runtime()
    if device is not None:
        local = (resolve_device(device),) * (1 if n_devices is None
                                             else int(n_devices))
    else:
        if n_devices is not None and int(n_devices) != rt.world:
            raise ValueError(
                f"make_mesh({n_devices}) without a device places one shard on "
                f"each process's card, and there are {rt.world} processes; "
                "pass device=... for several shards a process")
        local = (rt.device,)
    layouts = multihost.all_gather_object(
        [(str(d), multihost.card_id(d)) for d in local])
    if len({len(lay) for lay in layouts}) != 1:
        raise ValueError("every process must hold as many shards of the mesh; "
                         f"got {[len(lay) for lay in layouts]}")
    return Mesh(devices=tuple(torch.device(d) for lay in layouts
                              for d, _ in lay),
                processes=tuple(p for p, lay in enumerate(layouts)
                                for _ in lay),
                cards=tuple(c for lay in layouts for _, c in lay),
                process=rt.rank)


class ShardedState(NamedTuple):
    """A `system.SimState` placed on ``mesh`` by `shard_state`:
    ``shards[k]`` is shard k's local state, its tensors on
    ``mesh.devices[k]``; ``shell_mode`` is "sharded", "replicated" or
    "none" (`parallel.spmd.spmd_shell_mode`)."""

    shards: tuple
    mesh: Mesh
    shell_mode: str

    @property
    def time(self) -> float:
        return self.shards[0].time


def _to(nt, device):
    """NamedTuple ``nt`` (or None) with its tensor fields on ``device``
    (the same tensors where they already lie there)."""
    if nt is None:
        return None
    return nt._replace(**{k: v.to(device) for k, v in nt._asdict().items()
                          if torch.is_tensor(v)})


def _rows(nt, k: int, n: int, device, copy: bool = False):
    """Block ``k`` of ``n`` equal leading blocks of every tensor field of
    ``nt``, on ``device`` (views where it already lies there, unless
    ``copy``)."""
    def block(v):
        m = v.shape[0] // n
        return v[k * m:(k + 1) * m].to(device, copy=copy)

    return nt._replace(**{f: block(v) for f, v in nt._asdict().items()
                          if torch.is_tensor(v)})


def shard_state(state, mesh: Mesh, *, allow_replicated_shell: bool = False
                ) -> ShardedState:
    """Place a `SimState` on ``mesh`` for `System.step_spmd`, by field
    name, not shape: every fiber bucket splits into ``mesh.size`` blocks
    of whole fibers; a shell whose node count the mesh divides splits
    node-aligned (nodes, normals, weights, density and the rows of the two
    dense operators, `SHELL_ROW_SHARDED_FIELDS`); bodies, point and
    background sources, the flight ring, time and dt replicate. A fiber
    bucket the mesh does not divide, or a shell that cannot split, raises
    (`parallel.spmd.spmd_shell_mode`); ``allow_replicated_shell=True``
    puts the whole shell on every shard instead. Blocks on the state's own
    device are views: placing a state on one card copies nothing.

    On a mesh that spans processes every process passes the same whole
    state (built from the same config and seed) and keeps its own shards
    only, their row blocks copied, so that the caller can drop the whole
    state: a process's peak is the whole state plus its own rows."""
    from ..system.system import fiber_buckets
    from .spmd import spmd_shell_mode

    mode = spmd_shell_mode(state, mesh,
                           allow_replicated_shell=allow_replicated_shell)
    n = mesh.size
    copy = mesh.spans_processes
    shards = []
    for k in mesh.local:
        dev = mesh.devices[k]
        placed = [_rows(g, k, n, dev, copy)
                  for g in fiber_buckets(state.fibers)]
        shell = state.shell
        if shell is not None:
            shell = (_rows(shell, k, n, dev, copy) if mode == "sharded"
                     else _to(shell, dev))
        bodies = state.bodies
        if bodies is not None:
            bodies = (_to(bodies, dev) if hasattr(bodies, "_fields")
                      else tuple(_to(g, dev) for g in bodies))
        shards.append(state._replace(
            fibers=_rewrap(state.fibers, placed), shell=shell, bodies=bodies,
            points=_to(state.points, dev),
            background=_to(state.background, dev),
            flight=_to(state.flight, dev)))
    return ShardedState(tuple(shards), mesh, mode)


def _rewrap(field, buckets):
    """``buckets`` in the shape of ``field`` (one group or a tuple)."""
    return buckets[0] if hasattr(field, "_fields") else tuple(buckets)


def gather_state(sharded: ShardedState, device=None, *,
                 shell_operators: bool = True):
    """The `SimState` of a `ShardedState` on one ``device`` (default: shard
    0's): the fiber blocks and a sharded shell's rows concatenated in shard
    order, the replicated fields taken from shard 0. With
    ``shell_operators=False`` the shell's dense operators
    (`SHELL_ROW_SHARDED_FIELDS`) are left None, which saves their copy
    where only positions are read (a fast plan). On a mesh that spans
    processes every process calls it and gets the whole state: the
    sharded fields are all-gathered, the replicated ones taken from the
    process's first shard. The step never calls it, but for the tree's
    plan (positions only): it is for the writer, the tests and the caller
    that asks."""
    from ..system.system import fiber_buckets
    from . import multihost

    shards = sharded.shards
    spans = sharded.mesh.spans_processes
    dev = resolve_device(device) if device is not None else None
    first = shards[0]

    def cat(nts, skip=()):
        fields = {}
        for f in nts[0]._fields:
            vals = [getattr(nt, f) for nt in nts]
            if f in skip or not torch.is_tensor(vals[0]):
                fields[f] = None if f in skip else vals[0]
                continue
            out = torch.cat([v.to(vals[0].device) for v in vals])
            if spans:
                out = torch.cat(multihost.all_gather(out))
            fields[f] = out if dev is None else out.to(dev)
        return type(nts[0])(**fields)

    def place(nt):
        return nt if dev is None else _to(nt, dev)

    buckets = [cat([fiber_buckets(st.fibers)[i] for st in shards])
               for i in range(len(fiber_buckets(first.fibers)))]
    shell = first.shell
    skip = () if shell_operators else SHELL_ROW_SHARDED_FIELDS
    if shell is not None:
        if sharded.shell_mode == "sharded":
            shell = cat([st.shell for st in shards], skip)
        else:
            shell = place(shell._replace(**{f: None for f in skip}))
    bodies = first.bodies
    if bodies is not None:
        bodies = (place(bodies) if hasattr(bodies, "_fields")
                  else tuple(place(g) for g in bodies))
    return first._replace(
        fibers=None if first.fibers is None else _rewrap(first.fibers,
                                                         buckets),
        shell=shell, bodies=bodies, points=place(first.points),
        background=place(first.background), flight=place(first.flight))
