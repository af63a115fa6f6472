"""Rigid bodies (MTOCs/centrosomes) as first/second-kind boundary integrals.

Counterpart of `skellysim_tpu.bodies.bodies`: bodies of one surface
resolution live in batched [nb, n, ...] tensors; spherical and ellipsoidal
bodies share one formulation (the kind matters only for collisions).
Solution layout per body: [3n node densities (node-major xyz) | 6 rigid
velocities (U, omega)]. External forces support the Linear and Oscillatory
schedules. The dense body operators are built per body and factored with
one batched `torch.linalg.lu_factor_ex`.

The body double layer runs on the hand-written stresslet kernels C / D
through `ops.kernels.stresslet_direct` (or, with a fast plan, through the
Ewald / spectral stresslet sums); the COM Stokeslet goes through
`ops.kernels.stokeslet_direct` (kernels A / B on the card, as every
Stokeslet sum there; nb sources). The `deformable` body is a declared but
unimplemented stub in the reference and in the JAX package; the builder
refuses it as they do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernels
from ..utils import quaternion as quat

EXTFORCE_LINEAR = 0
EXTFORCE_OSCILLATORY = 1


class BodyGroup(NamedTuple):
    """Batched same-resolution rigid bodies ([nb] leading axis)."""

    nodes_ref: torch.Tensor        # [nb, n, 3]
    normals_ref: torch.Tensor      # [nb, n, 3]
    weights: torch.Tensor          # [nb, n]
    nucleation_sites_ref: torch.Tensor  # [nb, ns, 3]
    position: torch.Tensor         # [nb, 3]
    orientation: torch.Tensor      # [nb, 4] quaternion (w, x, y, z)
    solution: torch.Tensor         # [nb, 3n+6]
    velocity: torch.Tensor         # [nb, 3]
    angular_velocity: torch.Tensor  # [nb, 3]
    external_force: torch.Tensor   # [nb, 3]
    external_torque: torch.Tensor  # [nb, 3]
    ext_force_type: torch.Tensor   # [nb] int32 (Linear/Oscillatory)
    osc_amplitude: torch.Tensor    # [nb]
    osc_omega: torch.Tensor        # [nb]
    osc_phase: torch.Tensor        # [nb]
    radius: torch.Tensor           # [nb] attachment radius
    kind_sphere: torch.Tensor      # [nb] bool: sphere / ellipsoid
    semiaxes: torch.Tensor = None  # [nb, 3] ellipsoid semiaxes (0 otherwise)
    #: int32 [nb] config-order index: the GLOBAL body id fibers'
    #: `binding_body` refers to, and the trajectory's wire order
    config_rank: torch.Tensor = None

    @property
    def n_bodies(self) -> int:
        return self.nodes_ref.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.nodes_ref.shape[1]

    @property
    def solution_size(self) -> int:
        return self.n_bodies * (3 * self.n_nodes + 6)


class BodyCaches(NamedTuple):
    nodes: torch.Tensor       # [nb, n, 3] lab frame
    normals: torch.Tensor     # [nb, n, 3] lab frame
    nucleation_sites: torch.Tensor  # [nb, ns, 3] lab frame
    K: torch.Tensor           # [nb, 3n, 6]
    ex: torch.Tensor          # [nb, n, 3] singularity-subtraction vectors
    ey: torch.Tensor
    ez: torch.Tensor
    lu: torch.Tensor          # batched LU of the dense body operator
    piv: torch.Tensor


def make_group(nodes_ref, normals_ref, weights, *, position=None,
               orientation=None, nucleation_sites_ref=None,
               external_force=0.0, external_torque=0.0,
               ext_force_type=EXTFORCE_LINEAR, osc_amplitude=0.0,
               osc_omega=0.0, osc_phase=0.0, radius=0.0, kind="sphere",
               semiaxes=0.0, config_rank=None, dtype=torch.float64,
               device="cpu") -> BodyGroup:
    def t(v, d=dtype):
        return torch.as_tensor(v, device=device).to(d)

    nodes_ref = t(nodes_ref)
    if nodes_ref.ndim == 2:
        nodes_ref = nodes_ref[None]
    nb, n = nodes_ref.shape[0], nodes_ref.shape[1]

    def mat(v, shape, d=dtype):
        return t(v, d).broadcast_to(shape).clone()

    if nucleation_sites_ref is None:
        sites = torch.zeros((nb, 0, 3), dtype=dtype, device=device)
    else:
        sites = t(nucleation_sites_ref)
        if sites.ndim == 2:
            sites = sites[None].broadcast_to((nb,) + sites.shape).clone()

    return BodyGroup(
        nodes_ref=nodes_ref,
        normals_ref=mat(normals_ref, (nb, n, 3)),
        weights=mat(weights, (nb, n)),
        nucleation_sites_ref=sites,
        position=mat(0.0 if position is None else position, (nb, 3)),
        orientation=mat(quat.IDENTITY if orientation is None else orientation,
                        (nb, 4)),
        solution=torch.zeros((nb, 3 * n + 6), dtype=dtype, device=device),
        velocity=torch.zeros((nb, 3), dtype=dtype, device=device),
        angular_velocity=torch.zeros((nb, 3), dtype=dtype, device=device),
        external_force=mat(external_force, (nb, 3)),
        external_torque=mat(external_torque, (nb, 3)),
        ext_force_type=mat(ext_force_type, (nb,), torch.int32),
        osc_amplitude=mat(osc_amplitude, (nb,)),
        osc_omega=mat(osc_omega, (nb,)),
        osc_phase=mat(osc_phase, (nb,)),
        radius=mat(radius, (nb,)),
        kind_sphere=mat(kind == "sphere", (nb,), torch.bool),
        semiaxes=mat(semiaxes, (nb, 3)),
        config_rank=(torch.arange(nb, dtype=torch.int32, device=device)
                     if config_rank is None
                     else t(config_rank, torch.int32)),
    )


def as_buckets(bodies) -> tuple:
    """None | BodyGroup | iterable of buckets -> tuple of buckets
    (`BodyGroup` is itself a NamedTuple, so it is tested first)."""
    if bodies is None:
        return ()
    if isinstance(bodies, BodyGroup):
        return (bodies,)
    return tuple(bodies)


def n_total(bodies) -> int:
    """Total body count across buckets (the global `binding_body` id space)."""
    return sum(g.n_bodies for g in as_buckets(bodies))


def local_binding(fibers, group: BodyGroup, n_bodies_total: int):
    """A fibers view whose `binding_body` is the ``group``-local slot for
    fibers bound to a body of this bucket and -1 otherwise (the lookup is
    built from `config_rank`, the global id of each slot)."""
    dev = fibers.binding_body.device
    lookup = torch.full((max(n_bodies_total, 1),), -1, dtype=torch.int32,
                        device=dev)
    lookup[group.config_rank.long()] = torch.arange(
        group.n_bodies, dtype=torch.int32, device=dev)
    bb = fibers.binding_body
    local = torch.where(bb >= 0,
                        lookup[torch.clamp(bb, 0, n_bodies_total - 1).long()],
                        -1).to(torch.int32)
    return fibers._replace(binding_body=local)


# ----------------------------------------------------------------- kinematics

def place(group: BodyGroup):
    """Lab-frame nodes / normals / nucleation sites."""
    rot = quat.rotation_matrix(group.orientation)          # [nb, 3, 3]
    nodes = group.position[:, None, :] + torch.einsum("bij,bnj->bni", rot,
                                                      group.nodes_ref)
    normals = torch.einsum("bij,bnj->bni", rot, group.normals_ref)
    sites = group.position[:, None, :] + torch.einsum(
        "bij,bsj->bsi", rot, group.nucleation_sites_ref)
    return nodes, normals, sites


def _k_matrix(vec):
    """[nb, n, 3] COM offsets -> K [nb, 3n, 6]: node-major 3-row blocks
    [I | cross(r)]."""
    nb, n = vec.shape[0], vec.shape[1]
    K = torch.zeros((nb, n, 3, 6), dtype=vec.dtype, device=vec.device)
    K[:, :, 0, 0] = K[:, :, 1, 1] = K[:, :, 2, 2] = 1.0
    vx, vy, vz = vec[..., 0], vec[..., 1], vec[..., 2]
    K[:, :, 0, 4], K[:, :, 0, 5] = vz, -vy
    K[:, :, 1, 3], K[:, :, 1, 5] = -vz, vx
    K[:, :, 2, 3], K[:, :, 2, 4] = vy, -vx
    return K.reshape(nb, 3 * n, 6)


def update_cache(group: BodyGroup, eta, precond_dtype=None) -> BodyCaches:
    """Lab placement + singularity subtraction + K matrix + dense LU.
    ``precond_dtype`` factors the body operator in a lower precision (f32
    in mixed mode)."""
    nodes, normals, sites = place(group)
    nb, n = group.n_bodies, group.n_nodes

    sing = [[], [], []]
    for b in range(nb):
        for k in range(3):
            e = torch.zeros((n, 3), dtype=nodes.dtype, device=nodes.device)
            e[:, k] = group.weights[b]
            sing[k].append(kernels.stresslet_times_normal_times_density(
                nodes[b], normals[b], e, eta))
    ex, ey, ez = (torch.stack(s) for s in sing)
    K = _k_matrix(nodes - group.position[:, None, :])

    A = torch.zeros((nb, 3 * n + 6, 3 * n + 6), dtype=nodes.dtype,
                    device=nodes.device)
    for b in range(nb):
        M = kernels.stresslet_times_normal_blocked(nodes[b], normals[b], eta)
        kernels.subtract_singularity_columns(M, (ex[b], ey[b], ez[b]),
                                             group.weights[b])
        A[b, :3 * n, :3 * n] = M
    A[:, :3 * n, 3 * n:] = -K
    A[:, 3 * n:, :3 * n] = -K.transpose(1, 2)
    A[:, 3 * n:, 3 * n:] = torch.eye(6, dtype=A.dtype, device=A.device)
    if precond_dtype is not None:
        A = A.to(precond_dtype)
    # no pivot check: a nonfinite body reaches the health verdict
    # (`fibers.container.update_rhs_and_bc`)
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    return BodyCaches(nodes=nodes, normals=normals, nucleation_sites=sites,
                      K=K, ex=ex, ey=ey, ez=ez, lu=lu, piv=piv)


# ------------------------------------------------------------------ operators

def matvec(group: BodyGroup, caches: BodyCaches, x_bodies, v_bodies):
    """A_body x per body: ``x_bodies`` [nb, 3n+6], ``v_bodies`` [nb, n, 3]
    velocities at the body nodes."""
    nb, n = group.n_bodies, group.n_nodes
    d = x_bodies[:, :3 * n].reshape(nb, n, 3)
    U = x_bodies[:, 3 * n:]
    w = group.weights[..., None]
    c = (d[:, :, 0:1] / w * caches.ex + d[:, :, 1:2] / w * caches.ey
         + d[:, :, 2:3] / w * caches.ez)                       # [nb, n, 3]
    KU = torch.einsum("bik,bk->bi", caches.K, U)
    KTl = torch.einsum("bik,bi->bk", caches.K, d.reshape(nb, 3 * n))
    res_nodes = -c.reshape(nb, 3 * n) - KU + v_bodies.reshape(nb, 3 * n)
    return torch.cat([res_nodes, -KTl + U], dim=1)


def apply_preconditioner(group: BodyGroup, caches: BodyCaches, x_bodies):
    """Batched LU solves, in the factors' (possibly lower) precision and
    cast back."""
    out = torch.linalg.lu_solve(caches.lu, caches.piv,
                                x_bodies.to(caches.lu.dtype)[:, :, None])
    return out[:, :, 0].to(x_bodies.dtype)


def update_RHS(group: BodyGroup, v_on_bodies):
    """RHS = [-v_nodes, 0(6)] per body."""
    nb, n = group.n_bodies, group.n_nodes
    return torch.cat([-v_on_bodies.reshape(nb, 3 * n),
                      torch.zeros((nb, 6), dtype=v_on_bodies.dtype,
                                  device=v_on_bodies.device)], dim=1)


def flow(group: BodyGroup, caches: BodyCaches, r_trg, x_bodies,
         forces_torques, eta, impl: str = "exact", pair=None):
    """Body -> target velocities: the double-layer stresslet from the node
    densities (``impl`` picks its tier; ``x_bodies=None`` skips it) plus
    the COM Stokeslet from the forces and the rotlet from the torques
    (``forces_torques`` [nb, 6]), which take the exact tier whatever
    ``impl``, as in the JAX package. ``pair`` (an
    `ops.evaluator.PairEvaluator` whose Ewald, tree or spectral plan covers
    the body nodes and the targets) sums the node double layer through its
    plan instead (a depth-0 tree through the dense seam at ``impl``).
    Coincident body-node targets drop in every mode."""
    nb, n = group.n_bodies, group.n_nodes
    if x_bodies is None:
        v = torch.zeros_like(r_trg)
    else:
        densities = x_bodies[:, :3 * n].reshape(nb * n, 3)
        normals = caches.normals.reshape(nb * n, 3)
        f_dl = 2.0 * eta * normals[:, :, None] * densities[:, None, :]
        nodes = caches.nodes.reshape(nb * n, 3)
        if pair is not None:
            v = pair.stresslet(nodes, r_trg, f_dl, eta, impl)
        else:
            v = kernels.stresslet_direct(nodes, r_trg, f_dl, eta, impl=impl)
    v = v + kernels.stokeslet_direct(group.position, r_trg,
                                     forces_torques[:, :3], eta)
    return v + kernels.rotlet(group.position, r_trg, forces_torques[:, 3:],
                              eta)


def external_forces_torques(group: BodyGroup, time):
    """Linear / oscillatory force schedule [nb, 6]."""
    osc = group.osc_amplitude * torch.sin(group.osc_omega * time
                                          - group.osc_phase)
    scale = torch.where(group.ext_force_type == EXTFORCE_OSCILLATORY, osc,
                        1.0)
    return torch.cat([scale[:, None] * group.external_force,
                      group.external_torque], dim=1)


def step(group: BodyGroup, body_sol, dt) -> BodyGroup:
    """Integrate the rigid motion over dt."""
    n = group.n_nodes
    U = body_sol[:, 3 * n:3 * n + 3]
    omega = body_sol[:, 3 * n + 3:]
    dq = quat.from_rotation_vector(omega * dt)
    new_q = quat.normalize(quat.multiply(dq, group.orientation))
    return group._replace(position=group.position + U * dt, orientation=new_q,
                          solution=body_sol, velocity=U,
                          angular_velocity=omega)


# ------------------------------------------------------------- link conditions

def link_conditions(group: BodyGroup, caches: BodyCaches, fibers,
                    fiber_caches, fiber_sol, x_bodies):
    """Fiber <-> body attachment coupling: (velocities_on_fiber [nf, 7],
    body_forces_torques [nb, 6]); ``fiber_sol`` is [nf, 4n_f] in the
    [x|y|z|T] block layout and ``fibers.binding_body`` holds local slots
    (`local_binding`)."""
    nf, n_f = fibers.n_fibers, fibers.n_nodes
    nb, n = group.n_bodies, group.n_nodes
    dtype, dev = fiber_sol.dtype, fiber_sol.device
    if group.nucleation_sites_ref.shape[1] == 0:
        return (torch.zeros((nf, 7), dtype=dtype, device=dev),
                torch.zeros((nb, 6), dtype=dtype, device=dev))
    mats = fibers.mats

    attached = fibers.binding_body >= 0
    body_idx = torch.clamp(fibers.binding_body, 0, nb - 1).long()
    site_idx = torch.clamp(fibers.binding_site, 0,
                           group.nucleation_sites_ref.shape[1] - 1).long()
    body_vel = x_bodies[:, 3 * n:3 * n + 3]
    body_omega = x_bodies[:, 3 * n + 3:]

    sites = caches.nucleation_sites[body_idx, site_idx]          # [nf, 3]
    site_pos = sites - group.position[body_idx]                  # body frame
    x_new = torch.stack([fiber_sol[:, :n_f], fiber_sol[:, n_f:2 * n_f],
                         fiber_sol[:, 2 * n_f:3 * n_f]], dim=-1)
    T0 = fiber_sol[:, 3 * n_f]
    xs0 = fiber_caches.xs[:, 0]

    s = 2.0 / fibers.length
    xss0 = (s[:, None] ** 2) * torch.einsum("j,fjk->fk", mats.D2[0], x_new)
    xsss0 = (s[:, None] ** 3) * torch.einsum("j,fjk->fk", mats.D3[0], x_new)

    E = fibers.bending_rigidity[:, None]
    cross = torch.linalg.cross
    F_body = -E * xsss0 + xs0 * T0[:, None]
    L_body = (-E * cross(site_pos, xsss0)
              + cross(site_pos, xs0) * T0[:, None]
              + E * cross(xs0, xss0))
    ft = torch.where(attached[:, None], torch.cat([F_body, L_body], dim=1),
                     0.0)
    # each body's fibers summed by a fixed-order reduction: `index_add_`
    # accumulates with atomics on the card, in an order that changes from
    # run to run
    mine = body_idx[None, :] == torch.arange(nb, device=dev)[:, None]
    body_ft = torch.where(mine[:, :, None], ft[None], 0.0).sum(dim=1)

    vb = body_vel[body_idx]
    wb = body_omega[body_idx]
    v_fiber = -vb - cross(wb, site_pos)
    tension_cond = (-torch.sum(xs0 * vb, dim=1)
                    + torch.sum(cross(xs0, site_pos) * wb, dim=1))
    site_hat = site_pos / torch.linalg.vector_norm(site_pos, dim=1,
                                                   keepdim=True)
    w_fiber = cross(site_hat, wb)
    v7 = torch.cat([v_fiber, tension_cond[:, None], w_fiber], dim=1)
    return torch.where(attached[:, None], v7, 0.0), body_ft


def repin_to_bodies(fibers, nucleation_sites, group: BodyGroup):
    """Move attached fiber minus ends back onto their (lab-frame, [nb, ns,
    3]) nucleation sites."""
    if group.nucleation_sites_ref.shape[1] == 0:
        return fibers
    attached = fibers.binding_body >= 0
    body_idx = torch.clamp(fibers.binding_body, 0, group.n_bodies - 1).long()
    site_idx = torch.clamp(fibers.binding_site, 0,
                           group.nucleation_sites_ref.shape[1] - 1).long()
    sites = nucleation_sites[body_idx, site_idx]
    delta = torch.where(attached[:, None], sites - fibers.x[:, 0], 0.0)
    return fibers._replace(x=fibers.x + delta[:, None, :])


# ------------------------------------------------------------------ collisions

def check_collision_shell(group: BodyGroup, shell_radius, threshold):
    """Spherical body vs spherical periphery; non-sphere pairs never
    collide (reference stub parity)."""
    dist = torch.linalg.vector_norm(group.position, dim=1) + group.radius
    return bool(torch.any((dist > (shell_radius - threshold))
                          & group.kind_sphere))


def check_collision_pairwise(position, radius, kind_sphere, threshold):
    """Sphere-sphere body collisions over [nb] columns."""
    nb = position.shape[0]
    d2 = torch.sum((position[:, None, :] - position[None, :, :]) ** 2, dim=-1)
    rsum = radius[:, None] + radius[None, :] + threshold
    both = kind_sphere[:, None] & kind_sphere[None, :]
    offdiag = ~torch.eye(nb, dtype=torch.bool, device=position.device)
    return bool(torch.any((d2 < rsum**2) & both & offdiag))


def check_collision_pairwise_multi(buckets, threshold):
    """Sphere-sphere collisions across ALL buckets."""
    buckets = as_buckets(buckets)
    if not buckets:
        return False
    return check_collision_pairwise(
        torch.cat([g.position for g in buckets]),
        torch.cat([g.radius for g in buckets]),
        torch.cat([g.kind_sphere for g in buckets]), threshold)


def check_collision_shell_multi(buckets, shell_radius, threshold):
    return any(check_collision_shell(g, shell_radius, threshold)
               for g in as_buckets(buckets))
