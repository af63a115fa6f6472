"""Capacity buckets: one policy that quantizes scene shapes onto padded rungs.

Counterpart of `skellysim_tpu.system.buckets`, whose docstring gives the
design: three ladders quantize a scene's shape axes onto a few capacity
rungs, each padded with inert masked capacity,

* fiber count: inactive replicated slots (`fibers.container.grow_capacity`);
* nodes per fiber: masked node rows whose matrices ride the group as data
  (`container.grow_node_capacity`, `matrices.FibMatsRT`);
* shell quadrature: masked rows whose operators grow block-diagonally with
  the identity (`periphery.grow_capacity`),

plus the spectral evaluator's FFT grid ladder, which quantizes plan data.
`bucketize(state, policy)` is the one door the run CLI, its ``--resume``
and the ensemble's admission call; the `BucketKey` names the bucket. The
default policy is the identity. In the port a bucket shares no compiled
program (the step runs eagerly), but the ensemble stacks only members of
one bucket, and the padded scenes give the JAX package's steps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

from ..fibers import container as fc
from ..fibers.matrices import VALID_NODE_COUNTS

#: the geometric fiber-capacity ladder (x2 from 2, doubling past the last
#: rung): `[runtime] bucket_ladder = [-1]` and dynamic instability's growth
GEOMETRIC_FIBER_LADDER = (2, 4, 8, 16, 32, 64, 128, 256, 512,
                          1024, 2048, 4096, 8192, 16384)


class BucketKey(NamedTuple):
    """The bucket a bucketized state maps to: one ``(fiber_capacity,
    node_capacity)`` pair per resolution group, the padded shell size (None:
    no shell or an unpadded one) and whether the groups carry runtime node
    matrices."""

    fibers: tuple = ()
    shell: Optional[int] = None
    rt_nodes: bool = False

    def describe(self) -> str:
        fib = " + ".join(f"{cap}x{nn}" for cap, nn in self.fibers) or "none"
        return (f"fibers[{fib}]"
                + (" rt" if self.rt_nodes else "")
                + (f" shell[{self.shell}]" if self.shell is not None else ""))


def _rung(ladder, n: int) -> int:
    """Smallest ladder rung >= n; doubles past the last rung."""
    for r in ladder:
        if r >= n:
            return r
    r = ladder[-1] if ladder else 1
    while r < n:
        r *= 2
    return r


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The capacity ladders (each strictly ascending). The defaults are the
    identity: no fiber padding, every valid resolution a node rung, no
    shell padding, the built-in FFT grid rungs. `from_runtime` reads the
    `[runtime]` table; node rungs must be valid fiber resolutions."""

    fiber_ladder: tuple = ()
    node_ladder: tuple = VALID_NODE_COUNTS
    shell_ladder: tuple = ()
    #: spectral FFT grid-dimension rungs; () = `ops.spectral.GRID_RUNGS`
    grid_ladder: tuple = ()

    def __post_init__(self):
        for name in ("fiber_ladder", "node_ladder", "shell_ladder",
                     "grid_ladder"):
            lad = tuple(int(v) for v in getattr(self, name))
            if list(lad) != sorted(set(lad)) or any(v < 1 for v in lad):
                raise ValueError(
                    f"{name} must be strictly ascending positive ints, "
                    f"got {lad}")
            object.__setattr__(self, name, lad)
        bad = set(self.node_ladder) - set(VALID_NODE_COUNTS)
        if bad:
            raise ValueError(
                f"node_ladder rungs {sorted(bad)} are not valid fiber "
                f"resolutions {VALID_NODE_COUNTS}")
        if not self.node_ladder:
            raise ValueError("node_ladder must not be empty")

    @classmethod
    def from_runtime(cls, runtime) -> "BucketPolicy":
        """Policy from a `config.schema.RuntimeConfig` (None: defaults);
        ``bucket_ladder = [-1]`` selects `GEOMETRIC_FIBER_LADDER`, empty
        lists keep the identity."""
        if runtime is None:
            return cls()
        fib = tuple(runtime.bucket_ladder)
        if fib == (-1,):
            fib = GEOMETRIC_FIBER_LADDER
        return cls(
            fiber_ladder=fib,
            node_ladder=tuple(runtime.node_ladder) or VALID_NODE_COUNTS,
            shell_ladder=tuple(runtime.shell_ladder),
            grid_ladder=tuple(getattr(runtime, "grid_ladder", ())))

    def fiber_capacity(self, n: int) -> int:
        if not self.fiber_ladder:
            return max(n, 1)
        return _rung(self.fiber_ladder, max(n, 1))

    def node_capacity(self, n: int) -> int:
        cap = _rung(self.node_ladder, n)
        if cap not in VALID_NODE_COUNTS:
            raise ValueError(
                f"no node_ladder rung holds {n} nodes (ladder "
                f"{self.node_ladder}, valid resolutions {VALID_NODE_COUNTS})")
        return cap

    def shell_capacity(self, n: int) -> Optional[int]:
        if not self.shell_ladder:
            return None
        return _rung(self.shell_ladder, n)

    @property
    def node_polymorphism(self) -> bool:
        """True when the node ladder is coarser than the identity: groups
        then carry runtime matrices even at an exact fit."""
        return self.node_ladder != VALID_NODE_COUNTS


#: the policy every entry point uses unless a config overrides it
DEFAULT_POLICY = BucketPolicy()


def _shell_live(shell) -> int:
    return (int(shell.node_mask.sum()) if shell.node_mask is not None
            else shell.n_nodes)


def _rewrap(state, new_groups):
    if not new_groups:
        return state
    return state._replace(
        fibers=(new_groups[0] if isinstance(state.fibers, fc.FiberGroup)
                else tuple(new_groups)))


def state_key(state) -> BucketKey:
    """The `BucketKey` of a state's current (possibly padded) shapes."""
    buckets = fc.as_buckets(state.fibers)
    fibs = tuple((g.n_fibers, g.n_nodes) for g in buckets)
    shell = (state.shell.n_nodes
             if state.shell is not None and state.shell.node_mask is not None
             else None)
    return BucketKey(fibers=fibs, shell=shell,
                     rt_nodes=any(g.rt_mats is not None for g in buckets))


def bucketize(state, policy: BucketPolicy = None, *, node_multiple: int = 1,
              fiber_capacity: int | None = None,
              pair_evaluator: str = "direct"):
    """Pad ``state`` onto its policy bucket -> ``(padded_state,
    BucketKey)``: fiber slots round up to the fiber ladder (and to a
    ``node_multiple``-divisible node count, the ring's invariant), node
    rows to the node ladder, the shell to the shell ladder.
    ``fiber_capacity`` overrides the fiber rung of a single-group state.
    Idempotent; the identity under the default policy."""
    policy = policy or DEFAULT_POLICY
    buckets = list(fc.as_buckets(state.fibers))
    if fiber_capacity is not None and len(buckets) > 1:
        raise ValueError(
            "explicit fiber_capacity applies to single-resolution states; "
            "mixed-resolution scenes take their per-group ladder rungs")
    new_groups = []
    for g in buckets:
        n_cap = policy.node_capacity(fc.live_node_count(g))
        if n_cap != g.n_nodes or (policy.node_polymorphism
                                  and g.rt_mats is None):
            g = fc.grow_node_capacity(g, n_cap)
        cap = (fiber_capacity if fiber_capacity is not None
               else policy.fiber_capacity(g.n_fibers))
        if cap < g.n_fibers:
            raise ValueError(
                f"bucket fiber capacity {cap} below the scene's "
                f"{g.n_fibers} slots")
        new_groups.append(fc.grow_capacity(g, cap,
                                           node_multiple=node_multiple))
    state = _rewrap(state, new_groups)

    if state.shell is not None:
        cap = policy.shell_capacity(_shell_live(state.shell))
        if cap is not None:
            if pair_evaluator in ("ewald", "tree", "spectral"):
                raise ValueError(
                    "shell_ladder padding is incompatible with the fast "
                    "summation evaluators ('ewald'/'tree'/'spectral'; this "
                    f"config selects {pair_evaluator!r} and the shell would "
                    f"pad {_shell_live(state.shell)} -> {cap} quadrature "
                    "rows): padded rows replicate node 0 and would overflow "
                    "the planner's static cell/leaf/occupancy buckets (see "
                    "periphery.grow_capacity); use 'direct' or 'ring', or "
                    "drop [runtime] shell_ladder")
            from ..periphery import periphery as peri

            if cap != state.shell.n_nodes or state.shell.node_mask is None:
                state = state._replace(
                    shell=peri.grow_capacity(state.shell, cap))
    return state, state_key(state)


def bucketize_to(state, key: BucketKey, *, node_multiple: int = 1):
    """Pad ``state`` onto an explicit bucket ``key`` (whose rungs may
    exceed the scene's own); raises when the scene cannot fit it."""
    buckets = list(fc.as_buckets(state.fibers))
    if len(buckets) != len(key.fibers):
        raise ValueError(
            f"scene has {len(buckets)} fiber resolution group(s) but the "
            f"bucket holds {len(key.fibers)} ({key.describe()})")
    new_groups = []
    for g, (cap, n_cap) in zip(buckets, key.fibers):
        nl = fc.live_node_count(g)
        if nl > n_cap:
            raise ValueError(
                f"scene fibers have {nl} nodes but the bucket's node "
                f"capacity is {n_cap} ({key.describe()})")
        if g.n_fibers > cap:
            raise ValueError(
                f"scene needs {g.n_fibers} fiber slots but the bucket "
                f"holds {cap} ({key.describe()})")
        if key.rt_nodes:
            g = fc.grow_node_capacity(g, n_cap)
        elif nl != n_cap or g.rt_mats is not None:
            raise ValueError(
                f"scene fibers at {nl} live nodes cannot ride the static-"
                f"resolution bucket {key.describe()}; configure a "
                "[runtime] node_ladder for node polymorphism")
        new_groups.append(fc.grow_capacity(g, cap,
                                           node_multiple=node_multiple))
    state = _rewrap(state, new_groups)
    if key.shell is not None:
        from ..periphery import periphery as peri

        if state.shell is None:
            raise ValueError(
                f"bucket {key.describe()} expects a shell; scene has none")
        live = _shell_live(state.shell)
        if live > key.shell:
            raise ValueError(
                f"scene shell has {live} quadrature rows but the bucket's "
                f"capacity is {key.shell} ({key.describe()})")
        state = state._replace(shell=peri.grow_capacity(state.shell,
                                                        key.shell))
    return state


def admits(key: BucketKey, state) -> bool:
    """True when ``bucketize_to(state, key)`` would succeed (a shape-only
    check)."""
    buckets = list(fc.as_buckets(state.fibers))
    if len(buckets) != len(key.fibers):
        return False
    for g, (cap, n_cap) in zip(buckets, key.fibers):
        nl = fc.live_node_count(g)
        if g.n_fibers > cap or nl > n_cap:
            return False
        if not key.rt_nodes and (nl != n_cap or g.rt_mats is not None):
            return False
    if key.shell is not None:
        if state.shell is None or _shell_live(state.shell) > key.shell:
            return False
    return True


def pad_for_mesh(fibers, mesh_size: int):
    """Round each fiber group up to a mesh-divisible node count with inert
    padding slots (`fibers.container.grow_capacity`): the ring evaluator's
    divisibility invariant, which `System._fiber_flow` checks."""
    if fibers is None or mesh_size <= 1:
        return fibers
    if isinstance(fibers, fc.FiberGroup):
        return fc.grow_capacity(fibers, fibers.n_fibers,
                                node_multiple=mesh_size)
    return tuple(fc.grow_capacity(g, g.n_fibers, node_multiple=mesh_size)
                 for g in fibers)


def next_fiber_capacity(n_needed: int, policy: BucketPolicy = None) -> int:
    """Dynamic instability's growth target: the geometric rung that holds
    ``n_needed`` fibers, or the policy's own fiber rung when it sets a
    fiber ladder."""
    if policy is not None and policy.fiber_ladder:
        return policy.fiber_capacity(n_needed)
    return _rung(GEOMETRIC_FIBER_LADDER, max(n_needed, 1))
