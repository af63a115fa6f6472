"""The sharded implicit step: the whole step over a mesh of shards.

Counterpart of `skellysim_tpu.parallel.spmd`, where the step is one
`shard_map` program over the fiber axis. Here the step runs eagerly, each
process's shards' parts in turn, and the places where the JAX program
communicates are the calls of one small object, `Collectives`: ``psum``,
``all_gather`` and the ring. On a mesh of one process its entries are every
shard; on a mesh that spans processes (`parallel.multihost`) they are the
process's own shards, and the same three calls reach the other processes
over `torch.distributed`. The host's decisions (the iteration count, the
accept and reject) follow from replicated values, which are the same bits
in every process because every sum across shards is taken in shard order;
`_Step` checks that once a step.

Decomposition (each shard k of a mesh of D, `parallel.mesh.shard_state`):

* fiber buckets split along the batch axis (nf / D whole fibers a shard):
  the caches, the batched LU factors and their solves stay on their shard;
* the shell splits node-aligned (N / D nodes a shard): the rows of the two
  dense operators [3N / D, 3N], the density rows and the RHS rows; applying
  an operator is all-gather(density) and the local row block's product;
* bodies, sources and scalars replicate.

Collectives (`Collectives`):

* ``psum`` for the GMRES reductions (the solver's ``rdot`` seam, `_make_rdot`)
  and for the partial sums onto REPLICATED rows (body-node velocities, the
  link forces and torques: one bundle a matvec), each added in shard order,
  so that the sum is the same bits on every shard;
* the ring for every pair flow at shard-resident targets
  (`fibers.container.flow_multi_local`, `periphery.flow_local`): kernel E /
  F in one launch for the f32 Krylov interior on the card, A / C or B / D a
  hop otherwise (the f64-grade refinement flows included, so "mixed"
  refines inside the mesh);
* one density-sized ``all_gather`` a shell operator application;
* with the flight recorder armed, ``pmax`` / ``pmin`` over the shards'
  partial extrema and provenance keys (`obs.flight.record_step_sharded`),
  so that every shard writes the same row.

Replicated rows stay the same bits on every shard: they are computed from
replicated inputs only, or as a psum of per-shard partials, never by a ring
(each shard would add the same terms in its own order). The accept and
reject decision and the iteration count are the host's, once for all
shards. The JAX package's replication audit has no counterpart here; the
tests check the bits (`tests/test_torch_spmd.py`).

Under ``pair_evaluator = "tree"`` with every fiber slot active the Krylov
interior's fiber flows take the treecode on every shard (`build_spmd_step`'s
``pair``); the f64 refinement residual and prep flows of "mixed" stay
dense, the shell's double layer stays on the ring, and the bodies' on the
dense kernels, as in the JAX package. The other fast evaluators are not
served: the step always rings over its mesh.
"""

from __future__ import annotations

import math
import operator
import warnings
from typing import Callable, NamedTuple

import torch

from ..audit import observe as _observe
from ..bodies import bodies as bd
from ..fibers import container as fc
from ..guard import verdict as _verdict
from ..obs import cost as _cost
from ..obs.profile import phase
from ..periphery import periphery as peri
from ..solver import gmres, gmres_ir
from ..system.system import (StepInfo, _rewrap, _rewrap_fibers, body_buckets,
                             fiber_buckets)
from .mesh import Mesh, ShardedState
from .ring import _ring_or_fused


class Collectives:
    """The sharded step's collectives over ``mesh`` (``psum``, ``pmax`` /
    ``pmin``, ``all_gather``, ``ring``): the one seam between
    the step and the shards' placement. Every argument and result holds
    one entry a shard of this process (``mesh.local``; shard k's on its
    device): every shard in one process, or the process's own shards on a
    mesh that spans processes, whose entries then reach the others over
    `torch.distributed` (`parallel.multihost`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = mesh.local_devices

    @property
    def size(self) -> int:
        """Shards of the mesh (every process's)."""
        return self.mesh.size

    def every_shard(self, parts) -> list:
        """Every shard's entry of ``parts`` (this process's), in shard
        order, on the first entry's device."""
        dev = parts[0].device
        if not self.mesh.spans_processes:
            return [p.to(dev) for p in parts]
        from . import multihost

        stacked = multihost.all_gather(torch.stack([p.to(dev)
                                                    for p in parts]))
        return [p for blk in stacked for p in blk]

    def psum(self, parts) -> list:
        """The sum of the shards' ``parts``, each shard's copy: the entries
        added in shard order (gathered first across processes), then
        placed, so the result is the same bits on every shard of every
        process. An entry may be a tuple of tensors (one bundle, summed
        field by field; one gather for a bundle of one dtype)."""
        if isinstance(parts[0], tuple):
            fields = len(parts[0])
            if self.mesh.spans_processes and len(
                    {p.dtype for p in parts[0]}) == 1:
                sizes = [p.numel() for p in parts[0]]
                flat = self.psum([torch.cat([f.reshape(-1) for f in p])
                                  for p in parts])
                return [tuple(x.reshape(f.shape) for x, f in zip(
                    v.split(sizes), parts[0])) for v in flat]
            sums = [self.psum([p[i] for p in parts]) for i in range(fields)]
            return [tuple(s[k] for s in sums) for k in range(len(parts))]
        return self._fold(operator.add, parts)

    def _fold(self, op, parts) -> list:
        if _cost._ACTIVE is not None:
            _cost._ACTIVE.collective("all_reduce", parts)
        every = self.every_shard(parts)
        acc = every[0]
        for p in every[1:]:
            acc = op(acc, p)
        out = [acc.to(d) for d in self.devices]
        if _observe.ACTIVE is not None:
            _observe.ACTIVE.collective("all_reduce", parts, out)
        return out

    def pmax(self, parts) -> list:
        """The elementwise largest of the shards' ``parts`` (NaN wins, as
        in ``lax.pmax``), each shard's copy: gathered in shard order
        first, so that every shard of every process holds the same
        bits."""
        return self._fold(torch.maximum, parts)

    def pmin(self, parts) -> list:
        """The elementwise least of the shards' ``parts`` (`pmax`'s
        twin)."""
        return self._fold(torch.minimum, parts)

    def all_gather(self, parts) -> list:
        """The shards' ``parts`` concatenated in shard order (tiled along
        the leading axis), each shard's copy."""
        if _cost._ACTIVE is not None:
            _cost._ACTIVE.collective("all_gather", parts)
        full = torch.cat(self.every_shard(parts))
        out = [full.to(d) for d in self.devices]
        if _observe.ACTIVE is not None:
            _observe.ACTIVE.collective("all_gather", parts, out)
        return out

    def ring(self, kind, impl: str, block_fn, r_trg, *rotating,
             acc_dtype=None) -> list:
        """Each shard's resident targets ``r_trg[k]`` summed over every
        shard's ``rotating`` blocks: `parallel.ring._ring_or_fused` (the
        fused kernel E / F, or ``block_fn`` a hop)."""
        rotating = [list(r) for r in rotating]
        if _cost._ACTIVE is not None:
            _cost._ACTIVE.collective("collective_permute",
                                     list(zip(*rotating)))
        if _observe.ACTIVE is not None:
            _observe.ACTIVE.collective("collective_permute",
                                       list(zip(*rotating)))
        return _ring_or_fused(kind, impl, block_fn, self.mesh, list(r_trg),
                              *rotating, acc_dtype=acc_dtype)


class ShardVec:
    """One Krylov vector of the sharded step: one tensor a shard, shard
    k's rows [its resident rows | the replicated rows] on its device. It
    carries the vector operations `solver.gmres` uses besides its ``rdot``
    (`_make_rdot`): ``+``, ``-``, division by a scalar, row indexing of a
    basis, `zeros_like`, `basis`, `combine` and `apply`."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def _map(self, op, other=None):
        if isinstance(other, ShardVec):
            return ShardVec(op(a, b) for a, b in zip(self.parts, other.parts))
        return ShardVec(op(a, other) for a in self.parts)

    def __add__(self, other):
        return self._map(operator.add, other)

    def __sub__(self, other):
        return self._map(operator.sub, other)

    def __truediv__(self, scalar):
        return self._map(operator.truediv, scalar)

    def __getitem__(self, idx):
        return ShardVec(a[idx] for a in self.parts)

    def __setitem__(self, idx, value):
        for a, b in zip(self.parts, value.parts):
            a[idx] = b

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def zeros_like(self):
        return ShardVec(torch.zeros_like(a) for a in self.parts)

    def basis(self, rows: int):
        """A zero basis of ``rows`` vectors: [rows, n_k] a shard."""
        return ShardVec(torch.zeros((rows, a.shape[0]), dtype=a.dtype,
                                    device=a.device) for a in self.parts)

    def combine(self, c):
        """``c @ V`` of this basis slice: the same coefficients (a tensor)
        on every shard."""
        return ShardVec(c.to(a.device) @ a for a in self.parts)

    def apply(self, fn, *others):
        """``fn`` on each shard's part, with the same shard's parts of
        ``others``: the s-step cycle's row concatenation, transpose,
        triangular solve and masking, which act row block by row block."""
        return ShardVec(fn(a, *(o.parts[k] for o in others))
                        for k, a in enumerate(self.parts))


class SpmdSolution(NamedTuple):
    """The step's solution still sharded (``flat_solution=False``): per
    fiber bucket, per shard, its block [nf / D, 4n]; the shell density a
    shard (its rows, or the whole replicated density); the body solution a
    shard (replicated)."""

    fibers: tuple
    shell: tuple | None
    bodies: tuple | None


def spmd_shell_mode(state, mesh: Mesh, *,
                    allow_replicated_shell: bool = False) -> str:
    """Validate a `SimState` for the sharded step; returns the shell's
    placement ("sharded" | "replicated" | "none"). The shell must split
    node-aligned (n_nodes % D == 0, so that a node's three density
    components never straddle shards) and every fiber bucket must divide
    the mesh (`fibers.container.grow_capacity` pads a batch up)."""
    buckets = fiber_buckets(state.fibers)
    if not buckets:
        raise ValueError(
            "the SPMD step shards the fiber batch axis; a fiberless state "
            "has nothing to distribute (use the plain solve)")
    for g in buckets:
        if g.n_fibers % mesh.size != 0:
            raise ValueError(
                f"fiber bucket of {g.n_fibers} fibers does not divide the "
                f"mesh size ({mesh.size}); round the batch up with "
                "fibers.container.grow_capacity (inactive padding fibers "
                "are free)")
    if state.shell is None:
        return "none"
    if state.shell.n_nodes % mesh.size == 0:
        return "sharded"
    if allow_replicated_shell:
        return "replicated"
    raise ValueError(
        f"shell n_nodes ({state.shell.n_nodes}) is not divisible by the "
        f"mesh size ({mesh.size}), so the shell rows cannot be sharded "
        "node-aligned and the O(n_nodes^2) dense operators would replicate "
        "on every device. Pick a node count that is a multiple of "
        f"{mesh.size}, or pass allow_replicated_shell=True to accept the "
        "per-device memory cost.")


def _make_rdot(comm: Collectives, nonrep_end: int) -> Callable:
    """The GMRES reduction over the layout [sharded rows | replicated
    rows]: the shards' partials over their first ``nonrep_end`` rows
    psum'd, the replicated tail (the same bits on every shard) added
    once."""
    def rdot(A, w):
        # the phase of the solver's collective (`obs.profile.phase`)
        with phase("psum-dots"):
            part = comm.psum([a[..., :nonrep_end] @ x[:nonrep_end]
                              for a, x in zip(A.parts, w.parts)])[0]
            return (part
                    + A.parts[0][..., nonrep_end:] @ w.parts[0][nonrep_end:])
    return rdot


def _each(fn, *lists) -> list:
    """``fn`` on every shard's entries of ``lists``."""
    return [fn(*args) for args in zip(*lists)]


class _Step:
    """`build_spmd_step`'s step: `prep`, `make_matvec`, `make_precond`, the
    solve and the advance of the JAX package's program, over lists with
    one entry a shard."""

    def __init__(self, system, mesh: Mesh, state: ShardedState,
                 allow_replicated_shell: bool, flat_solution: bool, pair):
        p = system.params
        if state.mesh != mesh:
            raise ValueError(f"the state is placed on {state.mesh}, the step "
                             f"asked for {mesh}")
        if state.shell_mode == "replicated" and not allow_replicated_shell:
            raise ValueError(
                f"the state's shell ({state.shards[0].shell.n_nodes} nodes) "
                "is replicated on every "
                "shard; pass allow_replicated_shell=True to step it")
        if any(d.type != system.device.type for d in mesh.devices):
            raise ValueError(f"the mesh's shards lie on {mesh.devices}, the "
                             f"system on {system.device}")
        self.system, self.mesh = system, mesh
        self.comm = Collectives(mesh)
        self.flat_solution = flat_solution
        self.shell_mode = state.shell_mode
        self.sharded_shell = self.shell_mode == "sharded"
        self.has_shell = self.shell_mode != "none"
        first = state.shards[0]
        self.precision = system._precision_for(first)
        is_f64 = system._dtype(first) == torch.float64
        # mixed f64: prep flows AND the refinement-residual matvec both
        # run through the refinement tile (System._prep / _solve_once)
        self.refine = self.precision == "mixed" and is_f64
        self.hi_impl = self.prep_impl = (system._refine_impl if self.refine
                                         else p.kernel_impl)
        self.precond_dtype = (torch.float32 if self.precision == "mixed"
                              else None)
        if pair is not None and pair.evaluator != "tree":
            raise ValueError(
                f"build_spmd_step(pair=...) composes only the 'tree' "
                f"evaluator with the SPMD step, got {pair.evaluator!r}; "
                "pass pair=None for the ring flows")
        if pair is not None and not all(
                bool(g.active.all()) for st in state.shards
                for g in fiber_buckets(st.fibers)):
            raise ValueError(
                "build_spmd_step(pair=...) requires every fiber slot "
                "active: the SPMD layout cannot spread inactive padding "
                "nodes, which would overflow the fast plan's static leaf "
                "buckets; pass pair=None (ring flows) for states with "
                "inactive capacity")
        self.pair = pair
        # mixed-mode prep flows stay dense through the refinement tile, as
        # in System._prep (tree_tol must not cap the RHS accuracy)
        self.prep_pair = None if self.refine else pair

    # ------------------------------------------------------------- layout

    def node_targets(self, st, body_caches):
        """(r_loc, r_rep, fiber nodes): shard-resident target rows (the
        shard's fiber nodes [+ its shell rows]) and replicated target rows
        ([a replicated shell's nodes +] body nodes; None without)."""
        parts_loc = [fc.node_positions(g) for g in fiber_buckets(st.fibers)]
        nf_l = sum(g.n_fibers * g.n_nodes for g in fiber_buckets(st.fibers))
        if self.sharded_shell:
            parts_loc.append(st.shell.nodes)
        parts_rep = []
        if self.shell_mode == "replicated":
            parts_rep.append(st.shell.nodes)
        for i, g in enumerate(body_buckets(st.bodies)):
            nodes = (body_caches[i].nodes if body_caches is not None
                     else bd.place(g)[0])
            parts_rep.append(nodes.reshape(-1, 3))
        r_rep = torch.cat(parts_rep) if parts_rep else None
        return torch.cat(parts_loc), r_rep, nf_l

    def targets(self, sts, bcs):
        """`node_targets` of every shard: (r_loc list, r_rep list or None,
        fiber nodes a shard)."""
        tg = _each(self.node_targets, sts, bcs)
        r_rep = [t[1] for t in tg]
        return ([t[0] for t in tg], None if r_rep[0] is None else r_rep,
                tg[0][2])

    def rep_splits(self, st):
        """(shell rows, body rows) node counts inside the r_rep block."""
        ns_rep = st.shell.n_nodes if self.shell_mode == "replicated" else 0
        nb = sum(g.n_bodies * g.n_nodes for g in body_buckets(st.bodies))
        return ns_rep, nb

    def split(self, st, x):
        """Shard ``x`` -> (fiber views [nf_l, 4n] a bucket, shell rows,
        body views [nb, 3n + 6] a bucket)."""
        fib_size, shell_size, _ = self.system._sizes(st)
        x_fibs, off = [], 0
        for g in fiber_buckets(st.fibers):
            size = fc.solution_size(g)
            x_fibs.append(x[off:off + size].reshape(g.n_fibers,
                                                    4 * g.n_nodes))
            off += size
        x_bods, off = [], fib_size + shell_size
        for g in body_buckets(st.bodies):
            x_bods.append(x[off:off + g.solution_size].reshape(
                g.n_bodies, 3 * g.n_nodes + 6))
            off += g.solution_size
        return x_fibs, x[fib_size:fib_size + shell_size], x_bods

    # --------------------------------------------------------------- prep

    def prep(self, sts):
        """`System._prep` in the sharded layout: the per-fiber work on the
        owning shard; the explicit flows ring at resident rows and psum
        onto replicated rows."""
        sys_, p = self.system, self.system.params
        sts = [sys_._update_plus_pinning(st) for st in sts]
        bcs = [[bd.update_cache(g, p.eta, precond_dtype=self.precond_dtype)
                for g in body_buckets(st.bodies)] or None for st in sts]
        r_loc, r_rep, nf_l = self.targets(sts, bcs)
        buckets = [fiber_buckets(st.fibers) for st in sts]
        caches = [[fc.update_cache(g, st.dt, p.eta) for g in b]
                  for st, b in zip(sts, buckets)]
        external = [sys_._periphery_force_fibers(st) for st in sts]
        motor_on = sts[0].time >= p.implicit_motor_activation_delay
        motor = [[fc.generate_constant_force(g, c) if motor_on
                  else torch.zeros_like(g.x) for g, c in zip(b, cs)]
                 for b, cs in zip(buckets, caches)]
        v_loc, v_part = fc.flow_multi_local(
            buckets, caches, external, r_loc, r_rep, p.eta, comm=self.comm,
            subtract_self=True, impl=self.prep_impl, pair=self.prep_pair)
        v_rep = None
        if r_rep is not None:
            v_rep = [torch.zeros_like(r) for r in r_rep]
        for k, st in enumerate(sts):
            for g, bc in zip(body_buckets(st.bodies), bcs[k] or []):
                ext_ft = bd.external_forces_torques(g, st.time)
                v_loc[k] = v_loc[k] + bd.flow(g, bc, r_loc[k], None, ext_ft,
                                              p.eta, impl=self.prep_impl)
                v_rep[k] = v_rep[k] + bd.flow(g, bc, r_rep[k], None, ext_ft,
                                              p.eta, impl=self.prep_impl)
            v_loc[k] = v_loc[k] + sys_._external_flows(st, r_loc[k])
            if r_rep is not None:
                v_rep[k] = v_rep[k] + sys_._external_flows(st, r_rep[k])
        if r_rep is not None:
            v_rep = _each(operator.add, v_rep, self.comm.psum(v_part))

        shell_rhs, body_rhs, new_caches = [], [], []
        for k, st in enumerate(sts):
            ns_rep, _ = self.rep_splits(st)
            rhs_b, off = [], ns_rep
            for g in body_buckets(st.bodies):
                nbn = g.n_bodies * g.n_nodes
                rhs_b.append(bd.update_RHS(g, v_rep[k][off:off + nbn].reshape(
                    g.n_bodies, g.n_nodes, 3)))
                off += nbn
            body_rhs.append(rhs_b)
            cs, off = [], 0
            for g, c, mo, ex in zip(buckets[k], caches[k], motor[k],
                                    external[k]):
                nfn = g.n_fibers * g.n_nodes
                v_fib = v_loc[k][off:off + nfn].reshape(g.n_fibers, g.n_nodes,
                                                        3)
                cs.append(fc.update_rhs_and_bc(
                    g, c, st.dt, p.eta, v_fib, mo + ex, ex,
                    precond_dtype=self.precond_dtype))
                off += nfn
            new_caches.append(cs)
            if self.has_shell:
                v_shell = (v_loc[k][nf_l:] if self.sharded_shell
                           else v_rep[k][:ns_rep])
                shell_rhs.append(peri.update_RHS(v_shell))
            else:
                shell_rhs.append(None)
        return sts, new_caches, bcs, shell_rhs, body_rhs

    # --------------------------------------------------------- the operator

    def make_matvec(self, sts, caches, bcs, lo=None, flow_impl=None,
                    pair=None):
        """`System._apply_matvec` in the sharded layout (the same ``lo``
        seam: the flows and the shell / body dense ops through the f32
        view, the stiff fiber-local rows in the solve dtype). ``pair``
        takes the fiber Stokeslet flow through the tree on every shard."""
        p = self.system.params
        impl = p.kernel_impl if flow_impl is None else flow_impl
        comm = self.comm
        f_sts, f_caches, f_bcs = (sts, caches, bcs) if lo is None else lo
        buckets = [fiber_buckets(st.fibers) for st in sts]
        f_buckets = [fiber_buckets(st.fibers) for st in f_sts]
        b_lists = [body_buckets(st.bodies) for st in sts]
        r_loc, r_rep, nf_l = self.targets(f_sts, f_bcs)
        has_bodies = bool(b_lists[0])

        def matvec(x: ShardVec) -> ShardVec:
            hi = x.dtype
            lo_dtype = hi if lo is None else torch.float32
            parts = _each(self.split, sts, x.parts)
            x_fibs = [q[0] for q in parts]
            x_shell = [q[1] for q in parts]
            x_bods = [q[2] for q in parts]
            fws = [[fc.apply_fiber_force(g, c, xf).to(lo_dtype)
                    for g, c, xf in zip(b, cs, xfs)]
                   for b, cs, xfs in zip(buckets, caches, x_fibs)]
            v_loc, v_part = fc.flow_multi_local(
                f_buckets, f_caches, fws, r_loc, r_rep, p.eta, comm=comm,
                subtract_self=True, impl=impl, pair=pair)
            if r_rep is not None:
                v_dense = [torch.zeros_like(r) for r in r_rep]

            if self.has_shell:
                # the shell's flow at fiber and body rows only; its
                # self-interaction lives in the dense operator
                rho = [xs.to(lo_dtype) for xs in x_shell]
                if self.sharded_shell:
                    sl, sp = peri.flow_local(
                        [st.shell for st in f_sts],
                        [r[:nf_l] for r in r_loc], r_rep, rho, p.eta,
                        comm=comm, impl=impl)
                    for k in range(len(comm.devices)):
                        v_loc[k][:nf_l] += sl[k]
                    if sp is not None:
                        v_part = _each(operator.add, v_part, sp)
                else:
                    # a replicated shell: the dense double layer from every
                    # node on every shard (replicated inputs: the same
                    # bits), added outside the psum of partials
                    for k, st in enumerate(f_sts):
                        ns_rep, _ = self.rep_splits(st)
                        r_fb = r_loc[k][:nf_l]
                        if r_rep is not None and r_rep[k].shape[0] > ns_rep:
                            r_fb = torch.cat([r_fb, r_rep[k][ns_rep:]])
                        vfb = peri.flow(st.shell, r_fb, rho[k], p.eta,
                                        impl=impl)
                        v_loc[k][:nf_l] += vfb[:nf_l]
                        if vfb.shape[0] > nf_l:
                            v_dense[k][ns_rep:] += vfb[nf_l:]

            # the body link conditions: per-shard fiber partials
            v_bnd = [[torch.zeros((g.n_fibers, 7), dtype=hi,
                                  device=g.x.device) for g in b]
                     for b in buckets]
            body_fts = None
            if has_bodies:
                body_fts = []
                for k in range(len(comm.devices)):
                    nbt = bd.n_total(b_lists[k])
                    fts = []
                    for gb, bc, xb in zip(b_lists[k], bcs[k], x_bods[k]):
                        ft = torch.zeros((gb.n_bodies, 6), dtype=hi,
                                         device=xb.device)
                        for i, (gf, c, xf) in enumerate(zip(
                                buckets[k], caches[k], x_fibs[k])):
                            vb, f = bd.link_conditions(
                                gb, bc, bd.local_binding(gf, gb, nbt), c, xf,
                                xb)
                            v_bnd[k][i] = v_bnd[k][i] + vb
                            ft = ft + f
                        fts.append(ft)
                    body_fts.append(fts)

            # ONE psum a matvec: the replicated rows' partial velocities
            # and the link forces / torques together
            v_rep = None
            if body_fts is not None:
                summed = comm.psum([(v_part[k], *body_fts[k])
                                    for k in range(len(comm.devices))])
                v_part = [s[0] for s in summed]
                body_fts = [list(s[1:]) for s in summed]
            elif r_rep is not None:
                v_part = comm.psum(v_part)
            if r_rep is not None:
                v_rep = _each(operator.add, v_part, v_dense)

            if self.sharded_shell:
                with phase("allgather-density"):
                    x_full = comm.all_gather(x_shell)
            out = []
            for k in range(len(comm.devices)):
                n_loc = r_loc[k].shape[0]
                if has_bodies:
                    r_all = torch.cat([r_loc[k], r_rep[k]])
                    for f_gb, f_bc, xb, ft in zip(
                            body_buckets(f_sts[k].bodies), f_bcs[k],
                            x_bods[k], body_fts[k]):
                        vflow = bd.flow(f_gb, f_bc, r_all, xb.to(lo_dtype),
                                        ft.to(lo_dtype), p.eta, impl=impl)
                        v_loc[k] = v_loc[k] + vflow[:n_loc]
                        v_rep[k] = v_rep[k] + vflow[n_loc:]
                res, off = [], 0
                for g, c, xf, vb in zip(buckets[k], caches[k], x_fibs[k],
                                        v_bnd[k]):
                    nfn = g.n_fibers * g.n_nodes
                    v_fib = v_loc[k][off:off + nfn].reshape(
                        g.n_fibers, g.n_nodes, 3).to(hi)
                    res.append(fc.matvec(g, c, xf, v_fib, vb).reshape(-1))
                    off += nfn
                ns_rep, _ = self.rep_splits(f_sts[k])
                if self.has_shell:
                    shell = f_sts[k].shell
                    if self.sharded_shell:
                        res.append(peri.matvec(shell, x_full[k].to(lo_dtype),
                                               v_loc[k][nf_l:]).to(hi))
                    else:
                        res.append(peri.matvec(shell, x_shell[k].to(lo_dtype),
                                               v_rep[k][:ns_rep]).to(hi))
                off = ns_rep
                for f_gb, f_bc, xb in zip(body_buckets(f_sts[k].bodies),
                                          f_bcs[k] or [], x_bods[k]):
                    nbn = f_gb.n_bodies * f_gb.n_nodes
                    v_b = v_rep[k][off:off + nbn].reshape(f_gb.n_bodies,
                                                          f_gb.n_nodes, 3)
                    res.append(bd.matvec(f_gb, f_bc, xb.to(lo_dtype), v_b)
                               .to(hi).reshape(-1))
                    off += nbn
                out.append(torch.cat(res))
            return ShardVec(out)

        return matvec

    # ---------------------------------------------------- the preconditioner

    def make_precond(self, sts, caches, bcs):
        """`System._apply_precond` in the sharded layout: the fiber LU
        solves on the owning shard; the shell solve all-gathers the density
        and applies the shard's M_inv rows; the Gauss-Seidel correction
        rings the shell blocks at fiber rows and psums the body rows'
        partial. In "mixed" the corrections run in the f32 view, as in
        `System._apply_precond`."""
        p = self.system.params
        comm = self.comm
        buckets = [fiber_buckets(st.fibers) for st in sts]
        b_lists = [body_buckets(st.bodies) for st in sts]
        r_loc, r_rep, nf_l = self.targets(sts, bcs)
        gs = p.precond == "gs" and self.has_shell

        def precond(x: ShardVec) -> ShardVec:
            # scoped as System._apply_precond is
            with phase("precond"):
                return precond_impl(x)

        def precond_impl(x: ShardVec) -> ShardVec:
            parts = _each(self.split, sts, x.parts)
            y_shell = [None] * len(comm.devices)
            if self.has_shell:
                x_shell = [q[1] for q in parts]
                if self.sharded_shell:
                    with phase("allgather-density"):
                        x_full = comm.all_gather(x_shell)
                    y_shell = [(st.shell.M_inv @ xf.to(st.shell.M_inv.dtype))
                               .to(x.dtype) for st, xf in zip(sts, x_full)]
                else:
                    y_shell = [peri.apply_preconditioner(st.shell, xs)
                               for st, xs in zip(sts, x_shell)]
            v_loc = v_rep = None
            if gs:
                rho = [y.to(st.shell.nodes.dtype)
                       for y, st in zip(y_shell, sts)]
                ns_rep, nb_nodes = self.rep_splits(sts[0])
                r_body = ([r[ns_rep:] for r in r_rep]
                          if r_rep is not None and nb_nodes else None)
                if self.sharded_shell:
                    v_loc, vp = peri.flow_local(
                        [st.shell for st in sts], [r[:nf_l] for r in r_loc],
                        r_body, rho, p.eta, comm=comm, impl=p.kernel_impl)
                    if vp is not None:
                        v_rep = comm.psum(vp)
                else:
                    v_loc, v_rep = [], None if r_body is None else []
                    for k, st in enumerate(sts):
                        r_fb = r_loc[k][:nf_l]
                        if r_body is not None:
                            r_fb = torch.cat([r_fb, r_body[k]])
                        v = peri.flow(st.shell, r_fb, rho[k], p.eta,
                                      impl=p.kernel_impl)
                        v_loc.append(v[:nf_l])
                        if r_body is not None:
                            v_rep.append(v[nf_l:])
            out = []
            for k in range(len(comm.devices)):
                x_fibs, _, x_bods = parts[k]
                res, off_v = [], 0
                for g, c, xf in zip(buckets[k], caches[k], x_fibs):
                    if v_loc is not None:
                        nfn = g.n_fibers * g.n_nodes
                        v_fib = v_loc[k][off_v:off_v + nfn].reshape(
                            g.n_fibers, g.n_nodes, 3)
                        # fiber rows of A at (0, y_shell, 0): the coupling
                        ld = g.x.dtype
                        xf = xf - fc.matvec(
                            g, c, torch.zeros_like(xf, dtype=ld),
                            v_fib.to(ld), torch.zeros((g.n_fibers, 7),
                                                      dtype=ld,
                                                      device=xf.device)
                        ).to(xf.dtype)
                        off_v += nfn
                    res.append(fc.apply_preconditioner(g, c, xf).reshape(-1))
                if y_shell[k] is not None:
                    res.append(y_shell[k])
                off_v = 0
                for g, bc, xb in zip(b_lists[k], bcs[k] or [], x_bods):
                    if v_rep is not None:
                        nbn = g.n_bodies * g.n_nodes
                        v_b = v_rep[k][off_v:off_v + nbn].reshape(
                            g.n_bodies, g.n_nodes, 3)
                        # body rows of A at (0, y_shell, 0) = [v_nodes, 0]
                        ld = bc.K.dtype
                        xb = xb - bd.matvec(g, bc,
                                            torch.zeros_like(xb, dtype=ld),
                                            v_b.to(ld)).to(xb.dtype)
                        off_v += nbn
                    res.append(bd.apply_preconditioner(g, bc, xb).reshape(-1))
                out.append(torch.cat(res))
            return ShardVec(out)

        return precond

    # ----------------------------------------------------------- the step

    def __call__(self, state: ShardedState):
        sys_, p, comm = self.system, self.system.params, self.comm
        # the phases of System._solve_once (`obs.profile.phase`)
        with phase("prep"):
            sts, caches, bcs, shell_rhs, body_rhs = self.prep(
                list(state.shards))
            rhs = ShardVec(torch.cat(
                [c.RHS.reshape(-1) for c in caches[k]]
                + ([shell_rhs[k]] if shell_rhs[k] is not None else [])
                + [br.reshape(-1) for br in body_rhs[k]])
                for k in range(len(comm.devices)))
        fib_size, shell_size, _ = sys_._sizes(sts[0])
        nonrep_end = fib_size + (shell_size if self.sharded_shell else 0)
        rdot = _make_rdot(comm, nonrep_end)

        with phase("gmres"):
            if self.precision == "mixed":
                lo_views = _each(sys_._lo_view, sts, caches, bcs)
                lo = tuple([v[i] for v in lo_views] for i in range(3))
                result = gmres_ir(
                    # the f64 residual matvec stays dense: tree_tol must not
                    # cap residual_true
                    self.make_matvec(sts, caches, bcs, flow_impl=self.hi_impl),
                    self.make_matvec(sts, caches, bcs, lo=lo, pair=self.pair),
                    rhs, precond_lo=self.make_precond(*lo),
                    tol=p.gmres_tol, inner_tol=p.inner_tol,
                    restart=p.gmres_restart, maxiter=p.gmres_maxiter,
                    max_refine=p.max_refine, history=p.gmres_history,
                    block_s=p.gmres_block_s, rdot=rdot)
            else:
                result = gmres(
                    self.make_matvec(sts, caches, bcs, pair=self.pair), rhs,
                    precond=self.make_precond(sts, caches, bcs),
                    tol=p.gmres_tol, restart=p.gmres_restart,
                    maxiter=p.gmres_maxiter, history=p.gmres_history,
                    block_s=p.gmres_block_s, rdot=rdot)

        with phase("advance"):
            new_sts, sol_fibs, sol_shell, sol_body = [], [], [], []
            for st, x in zip(sts, result.x.parts):
                x_fibs, x_shell, x_bods = self.split(st, x)
                new = st._replace(fibers=_rewrap_fibers(st.fibers, [
                    fc.step(g, xf) for g, xf in zip(fiber_buckets(st.fibers),
                                                    x_fibs)]))
                sol_fibs.append(x_fibs)
                if self.has_shell:
                    new = new._replace(shell=st.shell._replace(
                        density=x_shell))
                    sol_shell.append(x_shell)
                b_list = body_buckets(st.bodies)
                if b_list:
                    sol_body.append(x[fib_size + shell_size:])
                    new_b = [bd.step(g, xb, st.dt) for g, xb in zip(b_list,
                                                                    x_bods)]
                    new = new._replace(bodies=_rewrap(st.bodies, new_b,
                                                      bd.BodyGroup))
                    # the shard's fibers re-pin to their (moved) sites
                    nbt = bd.n_total(new_b)
                    repinned = list(fiber_buckets(new.fibers))
                    for gb in new_b:
                        sites = bd.place(gb)[2]
                        repinned = [g._replace(x=bd.repin_to_bodies(
                            bd.local_binding(g, gb, nbt), sites, gb).x)
                            for g in repinned]
                    new = new._replace(fibers=_rewrap_fibers(new.fibers,
                                                             repinned))
                new_sts.append(new)
            # pmax over the shards' buckets, read to the host once: NaN
            # wins there, where a Python max over each shard's float (one
            # host read a shard) dropped a NaN that was not first
            fiber_error = float(comm.pmax([torch.stack([
                fc.fiber_error(g) for g in fiber_buckets(st.fibers)]).max()
                for st in new_sts])[0])
            if self.mesh.spans_processes:
                fiber_error = _agree_across_processes(result, fiber_error)
            health = result.health | _verdict.nonfinite_word(fiber_error)
            if state.shards[0].flight is not None:
                # the flight row, the same bits on every shard: the reductions
                # are the collectives' pmax / pmin, the solution norm the
                # replicated rdot
                from ..obs import flight as flight_mod

                rings = flight_mod.record_step_sharded(
                    state.shards, new_sts, result.x.parts, comm=comm,
                    residual_true=result.residual_true, health=health,
                    dt_used=sts[0].dt, shell_shape=sys_.shell_shape,
                    solution_norm=torch.sqrt(rdot(result.x, result.x)),
                    sol_scan_rows=nonrep_end, shell_sharded=self.sharded_shell)
                new_sts = [st._replace(flight=r)
                           for st, r in zip(new_sts, rings)]
            info = StepInfo(
                converged=bool(result.converged), iters=result.iters,
                residual=result.residual, fiber_error=fiber_error,
                residual_true=result.residual_true,
                loss_of_accuracy=bool(
                    result.converged
                    and result.residual_true > 10.0 * p.gmres_tol),
                refines=result.refines, cycles=result.cycles,
                history=result.history, health=health, dt_used=sts[0].dt,
                guard_retries=0)
            new_state = ShardedState(tuple(new_sts), self.mesh,
                                     self.shell_mode)
            if not self.flat_solution:
                return new_state, SpmdSolution(
                    fibers=tuple(tuple(s[i] for s in sol_fibs)
                                 for i in range(len(sol_fibs[0]))),
                    shell=tuple(sol_shell) if self.has_shell else None,
                    bodies=tuple(sol_body) if sol_body else None), info
            every = self.comm.every_shard
            parts = [torch.cat(every([s[i] for s in sol_fibs])).reshape(-1)
                     for i in range(len(sol_fibs[0]))]
            if self.has_shell:
                parts.append(torch.cat(every(sol_shell)) if self.sharded_shell
                             else sol_shell[0])
            if sol_body:
                parts.append(sol_body[0])
            return new_state, torch.cat(parts), info


def _agree_across_processes(result, fiber_error: float) -> float:
    """The largest fiber error of every process's shards, after checking
    that every process's solve made the same host decisions: the same
    iterations, sweeps, convergence and residuals, bit for bit. A process
    that went its own way would hang at its next collective; this raises
    on every process instead."""
    from . import multihost

    mine = (result.iters, result.refines, result.cycles,
            bool(result.converged), result.health,
            float(result.residual).hex(), float(result.residual_true).hex())
    every = multihost.all_gather_object((mine, fiber_error))
    if any(d != every[0][0] for d, _ in every):
        raise RuntimeError(
            "the processes of the sharded step disagree on their solve "
            "(iterations, sweeps, cycles, converged, health, residual, true "
            f"residual by process): {[d for d, _ in every]}")
    errors = [e for _, e in every]
    return math.nan if any(math.isnan(e) for e in errors) else max(errors)


def build_spmd_step(system, mesh: Mesh, state: ShardedState, *,
                    allow_replicated_shell: bool = False,
                    flat_solution: bool = True, donate="auto", pair=None):
    """The sharded step for states laid out like ``state`` (a
    `parallel.mesh.ShardedState` on ``mesh``): ``step(state) ->
    (new_state, solution, info)``, ``new_state`` still sharded.

    ``pair`` (a tree `ops.evaluator.PairEvaluator` over the whole state)
    takes the Krylov interior's fiber Stokeslet flows through the treecode
    on every shard (`fibers.container.flow_multi_local`); it needs every
    fiber slot active and raises otherwise. ``flat_solution=True`` returns
    the solution in the reference's flat layout on shard 0's device (one
    gather of the solution vector); ``False`` an `SpmdSolution` of the
    shards' parts. ``donate`` is accepted and ignored: eager torch keeps no
    program whose input buffers it could alias (the JAX package's
    ``jit_wrapper`` seam has no counterpart either)."""
    del donate
    from ..guard.escalate import armed

    if armed(system.params):
        # the JAX package's diagnostic: the sharded step reports health
        # verdicts but runs no ladder
        warnings.warn("Params.guard_* escalation is not applied on the "
                      "step_spmd path: the sharded step reports health "
                      "verdicts but does not retry; escalation runs on "
                      "the one-device and ensemble paths only")
    return _Step(system, mesh, state, allow_replicated_shell, flat_solution,
                 pair)


def spmd_step(system, state: ShardedState, mesh: Mesh, *,
              allow_replicated_shell: bool = False,
              flat_solution: bool = True):
    """One sharded implicit step (`build_spmd_step`, then run)."""
    return build_spmd_step(system, mesh, state,
                           allow_replicated_shell=allow_replicated_shell,
                           flat_solution=flat_solution)(state)


# ---------------------------------------------------------------- the registry

def auditable_programs():
    """The sharded step's registry entries: the coupled step (16 fibers,
    the 56-node shell row-sharded, one forced body) at ``gmres_block_s =
    4`` on meshes of 2, 4 and 8 shards of one device
    (``make_mesh(n, device=...)``), the JAX package's ``step_spmd_d*``."""
    from ..audit import fixtures
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice
    from .mesh import make_mesh, shard_state

    def retrace_probe(device=None):
        # the built step on the fixture, then on the state it returned
        built = build(2)(device)
        return probe_twice(lambda: built.fn(*built.args),
                           lambda out: built.fn(out[0]))

    def build(n_dev):
        def _build(device=None):
            system = fixtures.make_system(shell=True, device=device,
                                          gmres_block_s=4)
            mesh = make_mesh(n_dev, device=system.device)
            state = shard_state(fixtures.coupled_state(system), mesh)
            return BuiltProgram(build_spmd_step(system, mesh, state,
                                                flat_solution=False),
                                (state,), device=system.device)
        return _build

    return [AuditProgram(
        name=f"step_spmd_d{n_dev}", layer="parallel",
        summary=f"sharded coupled step on a mesh of {n_dev} shards of one "
                "device (row-sharded shell)",
        build=build(n_dev),
        retrace_probe=retrace_probe if n_dev == 2 else None)
        for n_dev in (2, 4, 8)]
