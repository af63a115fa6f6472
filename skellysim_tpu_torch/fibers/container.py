"""Batched fiber state and operator assembly.

Counterpart of `skellysim_tpu.fibers.container`: all fibers of one resolution
live in dense [nf, n, ...] tensors and every per-fiber operation is one
batched call (`fd_fiber`). The ``active`` mask keeps inactive slots inert
exactly as the JAX package does (docs/audit.md "Masking discipline"): they
contribute zero flow, force and error and solve the identity.

A group may carry runtime node-padded matrices (``rt_mats``,
`matrices.FibMatsRT`; `grow_node_capacity`): its trailing node rows beyond
the live count are then masked inert capacity, as in the JAX package. The
direct, ring, Ewald, treecode and spectral pair evaluators, and the
sharded step's flow (`flow_multi_local`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import kernels
from . import fd_fiber
from .fd_fiber import FiberScalars
from .matrices import FibMatsRT, get_mats, padded_rt_mats, torch_mats

#: fibers per chunk of the dense self-mobility build (bounds the
#: [chunk, n, n, 3, 3] intermediates at large fiber counts)
_OSEEN_CHUNK = 1024


class FiberGroup(NamedTuple):
    """State of a batch of same-resolution fibers ([nf] leading axis)."""

    x: torch.Tensor             # [nf, n, 3] node positions
    tension: torch.Tensor       # [nf, n]
    length: torch.Tensor        # [nf] target length
    length_prev: torch.Tensor   # [nf] last accepted length
    bending_rigidity: torch.Tensor
    radius: torch.Tensor
    penalty: torch.Tensor
    beta_tstep: torch.Tensor
    force_scale: torch.Tensor
    v_growth: torch.Tensor
    minus_clamped: torch.Tensor  # bool [nf]
    plus_pinned: torch.Tensor    # bool [nf]
    binding_body: torch.Tensor   # int32 [nf], -1 = unbound
    binding_site: torch.Tensor   # int32 [nf]
    active: torch.Tensor         # bool [nf]
    #: int32 [nf] original config-order rank (trajectory wire order)
    config_rank: Optional[torch.Tensor] = None
    #: runtime node-capacity matrices (`matrices.FibMatsRT`) or None; when
    #: set, the node rows beyond the live count are masked inert capacity
    rt_mats: Optional[FibMatsRT] = None

    @property
    def n_fibers(self) -> int:
        return self.x.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.x.shape[1]

    @property
    def mats(self):
        if self.rt_mats is not None:
            return self.rt_mats.to(self.x.dtype, self.x.device)
        return torch_mats(self.n_nodes, self.x.dtype, self.x.device)

    def scalars(self) -> FiberScalars:
        return FiberScalars(self.length, self.length_prev, self.bending_rigidity,
                            self.radius, self.penalty, self.beta_tstep, self.v_growth)


class FiberCaches(NamedTuple):
    """Per-step derived quantities. ``A_bc``/``RHS``/``lu``/``piv`` are None
    until `update_rhs_and_bc` fills them (no placeholder allocations: at 10k
    fibers each [nf, 4n, 4n] leaf is gigabytes)."""

    xs: torch.Tensor          # [nf, n, 3]
    xss: torch.Tensor
    xsss: torch.Tensor
    xssss: torch.Tensor
    #: [nf, 3n, 3n] dense self-mobility, interleaved-xyz layout
    stokeslet: torch.Tensor
    force_op: Optional[torch.Tensor] = None  # [nf, 3n, 4n]
    A_bc: Optional[torch.Tensor] = None      # [nf, 4n, 4n] (BC-applied)
    RHS: Optional[torch.Tensor] = None       # [nf, 4n] (BC-applied)
    lu: Optional[torch.Tensor] = None        # batched LU factors of A_bc
    piv: Optional[torch.Tensor] = None


def make_group(x, lengths, bending_rigidity, radius, *, eta=None,
               penalty=fd_fiber.DEFAULT_PENALTY,
               beta_tstep=fd_fiber.DEFAULT_BETA_TSTEP, force_scale=0.0,
               v_growth=0.0, minus_clamped=False, binding_body=None,
               binding_site=None, config_rank=None, dtype=torch.float64,
               device="cpu") -> FiberGroup:
    """FiberGroup from [nf, n, 3] positions and broadcastable per-fiber params."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    nf, n = x.shape[0], x.shape[1]
    get_mats(n)  # validate resolution

    def vec(v, d=dtype):
        return torch.as_tensor(v, dtype=d, device=device).broadcast_to(
            (nf,)).clone()

    return FiberGroup(
        x=x,
        tension=torch.zeros((nf, n), dtype=dtype, device=device),
        length=vec(lengths), length_prev=vec(lengths),
        bending_rigidity=vec(bending_rigidity), radius=vec(radius),
        penalty=vec(penalty), beta_tstep=vec(beta_tstep),
        force_scale=vec(force_scale), v_growth=vec(v_growth),
        minus_clamped=vec(minus_clamped, torch.bool),
        plus_pinned=torch.zeros(nf, dtype=torch.bool, device=device),
        binding_body=vec(-1 if binding_body is None else binding_body,
                         torch.int32),
        binding_site=vec(-1 if binding_site is None else binding_site,
                         torch.int32),
        active=torch.ones(nf, dtype=torch.bool, device=device),
        config_rank=(torch.arange(nf, dtype=torch.int32, device=device)
                     if config_rank is None
                     else torch.as_tensor(config_rank, dtype=torch.int32,
                                          device=device)),
    )


def as_buckets(fibers) -> tuple:
    """None | FiberGroup | iterable of groups -> tuple of resolution buckets."""
    if fibers is None:
        return ()
    if isinstance(fibers, FiberGroup):
        return (fibers,)
    return tuple(fibers)


def node_positions(group: FiberGroup) -> torch.Tensor:
    """[nf * n, 3] flattened node positions."""
    return group.x.reshape(-1, 3)


def live_node_count(group: FiberGroup) -> int:
    """Live nodes a fiber (== n_nodes without node padding)."""
    if group.rt_mats is None:
        return group.n_nodes
    return int(group.rt_mats.node_mask.sum())


def node_mask_np(group: FiberGroup) -> np.ndarray:
    """Host [n] bool node mask (all True without node padding)."""
    if group.rt_mats is None:
        return np.ones(group.n_nodes, dtype=bool)
    return group.rt_mats.node_mask.cpu().numpy()


def strip_node_padding(group: FiberGroup) -> FiberGroup:
    """The group with its masked padding node rows removed and its runtime
    matrices dropped: the wire view (trajectory frames carry live nodes
    only, so a padded run writes an unpadded run's frames)."""
    if group.rt_mats is None:
        return group
    nl = live_node_count(group)
    return group._replace(x=group.x[:, :nl], tension=group.tension[:, :nl],
                          rt_mats=None)


def node_active_flat(group: FiberGroup) -> torch.Tensor:
    """[nf * n] bool: the node row is live and its fiber is active."""
    act = torch.repeat_interleave(group.active, group.n_nodes)
    if group.rt_mats is not None:
        act = act & group.rt_mats.node_mask.to(act.device).repeat(
            group.n_fibers)
    return act


def update_cache(group: FiberGroup, dt, eta) -> FiberCaches:
    """Derivatives, dense self-mobility and force operator (the BC/RHS stage
    needs the explicit flow field: `update_rhs_and_bc`)."""
    mats = group.mats
    sc = group.scalars()
    xs, xss, xsss, xssss = fd_fiber.derivatives(group.x, group.length_prev,
                                                mats)
    nf, n3 = group.n_fibers, 3 * group.n_nodes
    stokeslet = torch.empty((nf, n3, n3), dtype=group.x.dtype,
                            device=group.x.device)
    for f0 in range(0, nf, _OSEEN_CHUNK):
        xc = group.x[f0:f0 + _OSEEN_CHUNK]
        stokeslet[f0:f0 + _OSEEN_CHUNK] = kernels.oseen_tensor(
            xc, xc, eta).reshape(xc.shape[0], n3, n3)
    force_op = fd_fiber.force_operator(xs, xss, eta, sc, mats)
    return FiberCaches(xs=xs, xss=xss, xsss=xsss, xssss=xssss,
                       stokeslet=stokeslet, force_op=force_op)


def update_rhs_and_bc(group: FiberGroup, caches: FiberCaches, dt, eta,
                      v_on_fibers, f_total, f_ext,
                      precond_dtype=None) -> FiberCaches:
    """BC-applied A/RHS and the batched LU preconditioner.

    The RHS uses the total force (motor + external), the BC rows only the
    external force. ``precond_dtype`` stores the LU factors in a lower
    precision (f32 for the mixed solver) while A/RHS stay in the state
    dtype.
    """
    mats = group.mats
    sc = group.scalars()
    A = fd_fiber.build_A(caches.xs, caches.xss, caches.xsss, dt, eta, sc, mats)
    RHS = fd_fiber.build_RHS(group.x, caches.xs, caches.xss, dt, eta, sc, mats,
                             flow=v_on_fibers, f_external=f_total)
    A_bc, RHS_bc = fd_fiber.apply_bc_rectangular(
        A, RHS, group.x, caches.xs, caches.xss, dt, eta, sc, mats,
        group.minus_clamped, group.plus_pinned, v_on_fiber=v_on_fibers,
        f_on_fiber=f_ext)
    del A, RHS
    # inactive slots solve the identity so the LU stays well-posed
    eye = torch.eye(A_bc.shape[1], dtype=A_bc.dtype, device=A_bc.device)
    A_bc = torch.where(group.active[:, None, None], A_bc, eye)
    RHS_bc = torch.where(group.active[:, None], RHS_bc, 0.0)

    A_lu = A_bc if precond_dtype is None else A_bc.to(precond_dtype)
    # `_ex`: no check of the pivots. A nonfinite state must reach the
    # solver's health verdict (as in the JAX package, whose LU never
    # raises); the CUDA backend's check refuses a NaN matrix outright
    lu, piv, _ = torch.linalg.lu_factor_ex(A_lu)
    return caches._replace(A_bc=A_bc, RHS=RHS_bc, lu=lu, piv=piv)


def weighted_forces(group: FiberGroup, forces) -> torch.Tensor:
    """Quadrature-weighted node forces 0.5 * L * w0 * f; inactive fibers
    weigh zero (selected AFTER the product: zeroing only the weight would
    leave 0 * inf = NaN for nonfinite stale force bits)."""
    w0 = group.mats.weights0
    w = 0.5 * group.length[:, None] * w0[None, :]
    return torch.where(group.active[:, None, None], w[:, :, None] * forces,
                       0.0)


def flow(group: FiberGroup, caches: FiberCaches, r_trg, forces, eta,
         subtract_self: bool = True, evaluator: str = "direct", mesh=None,
         impl: str = "exact", pair=None) -> torch.Tensor:
    """Velocity at targets from every node of one bucket
    (`skellysim_tpu.fibers.container.flow`): `flow_multi` over
    ``(group,)``, through the same pair seam (kernel A / B on the card for
    the direct sum). ``forces`` is [nf, n, 3]; with ``subtract_self`` the
    leading nf * n targets are the fiber nodes."""
    return flow_multi((group,), (caches,), r_trg, (forces,), eta,
                      subtract_self=subtract_self, evaluator=evaluator,
                      mesh=mesh, impl=impl, pair=pair)


def _spread_inactive(buckets, pos, fills):
    """Replace inactive slots' node rows with the planner's spread fill
    sequence, indexed by compacted rank among the inactive nodes so the
    runtime fill set is exactly the first-n_fill prefix the planner counted
    occupancy for. Their weighted forces are zero, so only the bucket
    occupancy changes: left at the origin they would pile into one cell,
    past its capacity (where the JAX package's bucketing drops pairs
    silently)."""
    act = torch.cat([node_active_flat(g) for g in buckets])
    rank = torch.clamp_min(torch.cumsum(~act, 0) - 1, 0)
    return torch.where(act[:, None], pos, fills[rank])


def flow_multi(buckets, caches_list, r_trg, forces_list, eta,
               subtract_self: bool = True, evaluator: str = "direct",
               mesh=None, impl: str = "exact", pair=None) -> torch.Tensor:
    """Velocity at targets from every fiber node of every bucket, in ONE
    pair-evaluator pass (`skellysim_tpu.fibers.container.flow_multi`).

    ``pair`` (an `ops.evaluator.PairEvaluator`) sums through its Ewald,
    tree or spectral plan (a depth-0 tree through the dense seam at
    ``impl``), and ``evaluator`` is then unused. There the inactive slots'
    nodes are re-spread onto the plan's fill positions and the leading
    self targets rebuilt from them.

    ``evaluator="ring"`` with a ``mesh`` rotates the source blocks around
    the mesh (`parallel.ring`; the f64-grade "pallas_df" tier through
    `ring_stokeslet_df`, cast back to the target dtype); the caller pads the
    targets to a mesh multiple. Without a mesh the direct kernel runs.

    When ``subtract_self`` the leading targets are the concatenated fiber
    nodes in bucket order, and each fiber's dense self-interaction is
    subtracted (it is handled by the SBT mobility instead). That relies on
    the pair sum's self term being exactly zero.
    """
    if pair is None and evaluator not in ("direct", "ring"):
        raise ValueError(f"pair evaluator {evaluator!r} needs a plan: pass "
                         "a PairEvaluator built by ops.evaluator.make_pair")
    pos = torch.cat([node_positions(g) for g in buckets], dim=0)
    wf = torch.cat([weighted_forces(g, f).reshape(-1, 3)
                    for g, f in zip(buckets, forces_list)], dim=0)
    # dead slots' weighted forces are exact zeros: pin their positions to
    # the origin so no stale coordinate ever enters a pair kernel (the fast
    # branches then re-spread them onto fill positions)
    act = torch.cat([node_active_flat(g) for g in buckets])
    pos = torch.where(act[:, None], pos, 0.0)
    n_fib_nodes = pos.shape[0]
    if subtract_self:
        # keep the leading self targets consistent with the pinned sources
        r_trg = torch.cat([pos, r_trg[n_fib_nodes:]], dim=0)
    if pair is not None:
        pos = _spread_inactive(buckets, pos,
                               pair.fill_positions(n_fib_nodes, pos.dtype))
        n_self = n_fib_nodes if subtract_self else 0
        if n_self:
            # the leading targets are the fiber nodes: keep them coincident
            # with the spread sources so self pairs stay exact
            r_trg = torch.cat([pos, r_trg[n_self:]], dim=0)
        vel = pair.stokeslet(pos, r_trg, wf, n_self, eta, impl)
    elif evaluator == "ring" and mesh is not None:
        from ..parallel import ring

        if impl in ("df", "pallas_df"):
            vel = ring.ring_stokeslet_df(pos, r_trg, wf, eta, mesh=mesh,
                                         impl=impl).to(r_trg.dtype)
        else:
            vel = ring.ring_stokeslet(pos, r_trg, wf, eta, mesh=mesh,
                                      impl=impl)
    else:
        vel = kernels.stokeslet_direct(pos, r_trg, wf, eta, impl=impl)
    if subtract_self:
        off = 0
        for g, caches in zip(buckets, caches_list):
            nfn = g.n_fibers * g.n_nodes
            self_vel = torch.bmm(
                caches.stokeslet,
                wf[off:off + nfn].reshape(g.n_fibers, -1, 1))
            vel[off:off + nfn] -= self_vel.reshape(-1, 3)
            off += nfn
    return vel


def flow_multi_local(buckets, caches_list, forces_list, r_loc, r_rep, eta, *,
                     comm, subtract_self: bool = True, impl: str = "exact",
                     pair=None):
    """`flow_multi` for the sharded step (`parallel.spmd`; the JAX
    package's `flow_multi_local`), every argument one entry a shard:
    ``buckets[k]`` / ``caches_list[k]`` / ``forces_list[k]`` are shard k's
    resident fiber blocks, ``comm`` the step's collective seam
    (`parallel.spmd.Collectives`). Two target classes:

    * ``r_loc[k]``, the targets resident on shard k (its fiber nodes, its
      shell rows): every shard's sources reach them around the ring
      (`parallel.ring.ring_flow_local`, ``ring=True``);
    * ``r_rep[k]`` (or ``r_rep`` None), targets replicated on every shard
      (body nodes, a replicated shell): shard k's own sources only, a
      partial the caller adds across shards (``comm.psum``), so that the
      rows keep the same bits on every shard.

    Returns (v_loc, v_rep partial), a list each (None for an absent
    class). With ``subtract_self`` the leading rows of ``r_loc[k]`` are
    shard k's fiber nodes in bucket order, and each fiber's dense
    self-interaction is subtracted. The f64-grade tiles accumulate in
    float64 and cast back to the targets' dtype.

    A tree ``pair`` (`ops.evaluator.PairEvaluator`, depth >= 1) replaces
    the ring: the sources are all-gathered (``comm.all_gather``) and each
    shard sums them at its resident targets through the shared plan
    (kernel G), and its own sources at the replicated ones, each sum at
    its own call site (``("fibers", "shard", k, ...)``), so no shard's
    kept geometry serves another's. Every fiber slot must be active: no
    shard holds the global active mask that would spread inactive padding
    nodes (`parallel.spmd.build_spmd_step` checks this)."""
    from ..parallel.ring import ring_flow_local

    n = len(buckets)
    pos = [torch.cat([node_positions(g) for g in b], dim=0) for b in buckets]
    wf = [torch.cat([weighted_forces(g, f).reshape(-1, 3)
                     for g, f in zip(b, fs)], dim=0)
          for b, fs in zip(buckets, forces_list)]
    if (pair is not None and pair.evaluator == "tree"
            and pair.plan.depth > 0):
        pos_all = comm.all_gather(pos)
        wf_all = comm.all_gather(wf)
        v_loc, v_rep = [], None if r_rep is None else []
        for k in range(n):
            pk = pair.to(r_loc[k].device).at("fibers", "shard", k)
            v_loc.append(pk.at("resident").stokeslet(pos_all[k], r_loc[k],
                                                     wf_all[k], 0, eta))
            if r_rep is not None:
                v_rep.append(pk.at("replicated").stokeslet(
                    pos[k], r_rep[k], wf[k], 0, eta))
    else:
        v_loc = ring_flow_local("stokeslet", impl, r_loc, pos, wf, eta,
                                comm=comm, ring=True)
        v_rep = (None if r_rep is None else
                 ring_flow_local("stokeslet", impl, r_rep, pos, wf, eta,
                                 comm=comm, ring=False))
    if subtract_self:
        for k in range(n):
            off = 0
            for g, caches in zip(buckets[k], caches_list[k]):
                nfn = g.n_fibers * g.n_nodes
                self_vel = torch.bmm(
                    caches.stokeslet,
                    wf[k][off:off + nfn].reshape(g.n_fibers, -1, 1))
                v_loc[k][off:off + nfn] -= self_vel.reshape(-1, 3).to(
                    v_loc[k].dtype)
                off += nfn
    return v_loc, v_rep


def apply_fiber_force(group: FiberGroup, caches: FiberCaches, x_all) -> torch.Tensor:
    """Solution [nf, 4n] -> force density on nodes [nf, n, 3]."""
    f = torch.bmm(caches.force_op, x_all[:, :, None])[:, :, 0]  # [nf, 3n]
    n = group.n_nodes
    return torch.stack([f[:, :n], f[:, n:2 * n], f[:, 2 * n:]], dim=-1)


def matvec(group: FiberGroup, caches: FiberCaches, x_all, v_fib, v_boundary) -> torch.Tensor:
    """Block-diagonal fiber matvec [nf, 4n]."""
    res = fd_fiber.matvec(caches.A_bc, x_all, v_fib, v_boundary, caches.xs,
                          group.scalars(), group.mats, group.plus_pinned)
    return torch.where(group.active[:, None], res, x_all)


def apply_preconditioner(group: FiberGroup, caches: FiberCaches, x_all) -> torch.Tensor:
    """Batched LU solves [nf, 4n], in the factors' (possibly lower)
    precision and cast back — a preconditioner only approximates A^-1."""
    out = torch.linalg.lu_solve(caches.lu, caches.piv,
                                x_all.to(caches.lu.dtype)[:, :, None])
    return out[:, :, 0].to(x_all.dtype)


def step(group: FiberGroup, fiber_sol) -> FiberGroup:
    """Advance positions/tension from the solution [nf, 4n]."""
    n = group.n_nodes
    x_new = torch.stack([fiber_sol[:, :n], fiber_sol[:, n:2 * n],
                         fiber_sol[:, 2 * n:3 * n]], dim=-1)
    t_new = fiber_sol[:, 3 * n:]
    x_new = torch.where(group.active[:, None, None], x_new, group.x)
    t_new = torch.where(group.active[:, None], t_new, group.tension)
    if group.rt_mats is not None:
        # padded node entries solve the identity to exact zero; they keep
        # their placeholder positions (distinct finite coordinates keep the
        # self-mobility and the pair kernels finite)
        nm = group.mats.node_mask
        x_new = torch.where(nm[None, :, None], x_new, group.x)
        t_new = torch.where(nm[None, :], t_new, group.tension)
    return group._replace(x=x_new, tension=t_new, length_prev=group.length)


def generate_constant_force(group: FiberGroup, caches: FiberCaches) -> torch.Tensor:
    """Implicit motor force f = force_scale * xs [nf, n, 3]."""
    return group.force_scale[:, None, None] * caches.xs


def fiber_errors(group: FiberGroup) -> torch.Tensor:
    """[nf] per-fiber inextensibility violation, inactive slots 0 (the
    flight recorder's strain, `obs.flight`); `fiber_error` is its max."""
    errs = fd_fiber.fiber_error(group.x, group.length, group.mats)
    return torch.where(group.active, errs, 0.0)


def fiber_error(group: FiberGroup) -> torch.Tensor:
    """Max inextensibility violation over active fibers (0-d tensor); the
    -inf sentinel keeps inactive slots out of the max."""
    errs = fd_fiber.fiber_error(group.x, group.length, group.mats)
    return torch.clamp_min(
        torch.amax(torch.where(group.active, errs, -torch.inf)), 0.0)


def solution_size(group: FiberGroup) -> int:
    return group.n_fibers * 4 * group.n_nodes


def sort_fibers_morton(group: FiberGroup) -> FiberGroup:
    """Reorder the fibers by the Morton (Z-order) code of their centroids
    (`skellysim_tpu.fibers.container.sort_fibers_morton`), so consecutive
    fibers, and so the source chunks of the pair sums, are compact in
    space. Every per-fiber tensor rides along (``config_rank`` too, so
    ``config_rank[i]`` names the slot that fiber i came from); nothing
    indexes fibers by position. Host-side: the codes are computed on the
    host from one copy of the centroids; call it at setup, not a step."""
    nf = group.n_fibers
    if nf <= 1:
        return group
    # f64 codes whatever the group's dtype (an f32 span floored with a
    # denormal underflows to 0 and makes the codes NaN); node-padded groups
    # take the centroid over their live nodes only
    nm = torch.as_tensor(node_mask_np(group), device=group.x.device)
    cent = group.x[:, nm, :].mean(dim=1).cpu().numpy().astype(np.float64)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, np.finfo(np.float64).tiny)
    q = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(v):
        # interleave 10 bits with two zero bits (the Morton dilation)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    order = torch.as_tensor(np.argsort(code, kind="stable"),
                            device=group.x.device)

    def permute(leaf):
        # the group-level runtime matrices carry no fiber axis
        if (not torch.is_tensor(leaf) or leaf.ndim == 0
                or leaf.shape[0] != nf):
            return leaf
        return leaf[order]

    return type(group)(*[permute(leaf) for leaf in group])


def grow_capacity(group: FiberGroup, new_cap: int,
                  node_multiple: int = 1) -> FiberGroup:
    """Pad every [nf]-leading tensor to ``new_cap`` slots, the padding
    inactive (`skellysim_tpu.fibers.container.grow_capacity`).

    ``node_multiple`` (the mesh size) rounds ``new_cap`` further up until
    the total node count divides it: the ring evaluator's divisibility
    invariant. Padded slots replicate slot 0 instead of zero-filling (a
    zero-length, zero-x fiber makes the cache derivatives inf/NaN) and are
    inert: inactive and unbound.
    """
    if node_multiple > 1:
        while (new_cap * group.n_nodes) % node_multiple != 0:
            new_cap += 1
    nf = group.n_fibers
    pad = new_cap - nf
    if pad <= 0:
        return group

    def pad_leaf(leaf):
        # the group-level runtime matrices carry no fiber axis
        if (not torch.is_tensor(leaf) or leaf.ndim == 0
                or leaf.shape[0] != nf):
            return leaf
        if nf == 0:
            fill = leaf.new_zeros((pad,) + tuple(leaf.shape[1:]))
        else:
            fill = leaf[:1].expand((pad,) + tuple(leaf.shape[1:]))
        return torch.cat([leaf, fill], dim=0)

    padded = type(group)(*[pad_leaf(leaf) for leaf in group])
    live = torch.arange(new_cap, device=group.x.device) < nf
    return padded._replace(
        active=padded.active & live,
        binding_body=torch.where(live, padded.binding_body,
                                 torch.full_like(padded.binding_body, -1)))


def grow_node_capacity(group: FiberGroup, new_n: int) -> FiberGroup:
    """Pad the node axis to ``new_n`` rows a fiber, the padding masked
    inert (`skellysim_tpu.fibers.container.grow_node_capacity`): the live
    resolution's matrices become runtime data (`matrices.FibMatsRT`), and
    padded rows replicate the fiber's first node (zero quadrature weight:
    silent sources; exactly coincident pairs drop in every kernel).
    ``new_n == n_nodes`` still attaches runtime matrices, so an exact fit
    shares its bucket's structure."""
    n = group.n_nodes
    n_live = live_node_count(group)
    if new_n < n:
        raise ValueError(
            f"grow_node_capacity: new_n {new_n} below current node capacity "
            f"{n} (node capacity never shrinks)")
    rt = padded_rt_mats(n_live, new_n, group.x.dtype, group.x.device)
    pad = new_n - n
    if pad == 0:
        return group._replace(rt_mats=rt)
    x = torch.cat([group.x, group.x[:, :1].expand(-1, pad, -1)], dim=1)
    tension = torch.cat([group.tension,
                         group.tension.new_zeros((group.n_fibers, pad))],
                        dim=1)
    return group._replace(x=x, tension=tension, rt_mats=rt)
