"""Confining periphery (cell cortex) as a second-kind boundary integral.

Counterpart of `skellysim_tpu.periphery.periphery`: the dense precomputed
operator and its inverse live as tensors on the device; the matvec and the
preconditioner are single dense products. Operator assembly (the reference
SkellySim's `precompute.py:104-140`):

  M = stresslet_times_normal(nodes, normals; eta=1)
      - blockdiag([ex_i | ey_i | ez_i] / w_i)          (singularity subtraction)
      - diag(1/w_i per component)                       (second-kind identity)
      + n n^T                                           (null-space completion)
  M_inv = inverse(M)   (the preconditioner)

The shell double-layer flow to fiber and body nodes (`flow`) runs on the
hand-written stresslet kernels C / D through `ops.kernels.stresslet_direct`,
or, under the ring evaluator, on kernel F (f32) and D (a hop, f64-grade)
through `parallel.ring`, or through the fast evaluators' stresslet sums
(`ops.ewald`, `ops.treecode`, `ops.spectral`) when a plan is passed;
`flow_local` is the sharded step's (`parallel.spmd`). A shell may be
padded onto a capacity rung (`grow_capacity`, the `[runtime] shell_ladder`
of `system.buckets`): its ``node_mask`` marks the live quadrature rows, and
the padded rows solve the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import kernels


class PeripheryState(NamedTuple):
    """Device-resident shell state."""

    nodes: torch.Tensor        # [N, 3]
    normals: torch.Tensor      # [N, 3] (inward, as stored by precompute)
    weights: torch.Tensor      # [N]
    M_inv: torch.Tensor        # [3N, 3N] preconditioner
    stresslet_plus_complementary: torch.Tensor  # [3N, 3N] operator
    density: torch.Tensor      # [3N] current solution slice
    #: [N] bool live quadrature rows, or None (every row live). Padded rows
    #: (`grow_capacity`) carry zero normals and weights and solve the
    #: identity
    node_mask: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def solution_size(self) -> int:
        return 3 * self.n_nodes


@dataclass(frozen=True)
class PeripheryShape:
    """Static collision geometry. kind: 'sphere' | 'ellipsoid' | 'generic'."""

    kind: str = "generic"
    radius: float = 0.0
    abc: tuple = (0.0, 0.0, 0.0)


def _assemble(nodes, normals, weights, eta):
    """The dense second-kind operator M [3N, 3N], in the dtype and on the
    device of ``nodes`` (row-blocked, in place)."""
    N = nodes.shape[0]

    def sing_vec(k):
        e = torch.zeros((N, 3), dtype=nodes.dtype, device=nodes.device)
        e[:, k] = weights
        return kernels.stresslet_times_normal_times_density(nodes, normals, e,
                                                            eta)

    M = kernels.stresslet_times_normal_blocked(nodes, normals, eta)
    kernels.subtract_singularity_columns(M, (sing_vec(0), sing_vec(1),
                                             sing_vec(2)), weights)
    M.diagonal().sub_(torch.repeat_interleave(1.0 / weights, 3))
    flat = normals.reshape(-1)
    M.add_(torch.outer(flat, flat))
    return M


def build_shell_operator(nodes, normals, weights, eta: float = 1.0, *,
                         timings: dict | None = None):
    """Dense second-kind operator + inverse on the host in float64 (numpy
    arrays), as `skellysim_tpu.periphery.periphery.build_shell_operator`:
    the port's plain blocked builders, then scipy's LAPACK inverse.
    ``timings``, when given, receives the seconds of the assembly and of
    the inverse."""
    import time

    import scipy.linalg as scla

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    t0 = time.perf_counter()
    M = _assemble(t(nodes), t(normals), t(weights), eta).numpy()
    t1 = time.perf_counter()
    M_inv = scla.inv(M)
    if timings is not None:
        timings["assembly_s"] = t1 - t0
        timings["inverse_s"] = time.perf_counter() - t1
    return M, M_inv


def build_shell_operator_device(nodes, normals, weights, eta: float = 1.0, *,
                                device=None, timings: dict | None = None):
    """Dense second-kind operator + inverse, assembled and inverted on
    ``device`` (the card by default). Returns DEVICE tensors (M float64,
    M_inv float32).

    The JAX package assembles on its accelerator and inverts in f32 with a
    recursive Schur-complement `block_inv`, which exists only because the
    TPU's LU keeps an [n, 128] panel in a 16 MB VMEM budget and is f32-only.
    Neither limit holds on the card: the inverse here is one
    `torch.linalg.inv` of the float64 operator, then stored in float32 (the
    preconditioner's precision, as the JAX device path stores it).
    ``timings``, when given, receives the seconds of the assembly and of
    the inverse (each ended by a device synchronise).
    """
    import time

    from ..device import resolve_device

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    t0 = time.perf_counter()
    M = _assemble(t(nodes), t(normals), t(weights), eta)
    sync()
    t1 = time.perf_counter()
    M_inv = torch.linalg.inv(M).to(torch.float32)
    sync()
    if timings is not None:
        timings["assembly_s"] = t1 - t0
        timings["inverse_s"] = time.perf_counter() - t1
    return M, M_inv


def inverse_residual(M, M_inv) -> float:
    """max_j ||M M_inv e_j - e_j|| over 8 columns spread over the matrix,
    in M's dtype (the check the precompute CLI prints)."""
    n, n_cols = M.shape[0], 8
    cols = torch.linspace(0, n - 1, n_cols, device=M.device).long()
    prod = M @ M_inv[:, cols].to(M.dtype)
    prod[cols, torch.arange(n_cols, device=M.device)] -= 1.0
    return float(torch.linalg.vector_norm(prod, dim=0).max())


def make_state(nodes, normals, weights, operator, M_inv, dtype=torch.float64,
               precond_dtype=None, device="cpu") -> PeripheryState:
    """``precond_dtype`` stores M_inv (the preconditioner) in a lower
    precision, halving its device memory in mixed mode. Every tensor is
    made row-major: an inverse saved from the card is column-major, and a
    product's bits follow the layout (a copy, such as an ensemble's stacked
    lanes, would otherwise sum in another order than the original)."""
    def t(a, dt=dtype):
        return torch.as_tensor(a, device=device).to(dt).contiguous()

    N = len(nodes)
    return PeripheryState(
        nodes=t(nodes), normals=t(normals), weights=t(weights),
        M_inv=t(M_inv, precond_dtype or dtype),
        stresslet_plus_complementary=t(operator),
        density=torch.zeros(3 * N, dtype=dtype, device=device))


def grow_capacity(shell: PeripheryState, new_n: int) -> PeripheryState:
    """The shell padded to ``new_n`` quadrature rows, the padding masked
    inert (`skellysim_tpu.periphery.periphery.grow_capacity`): padded rows
    replicate node 0's position with zero normals and weights (silent
    sources), and both dense operators grow block-diagonally with the
    identity, so padded density entries solve to exact zero.
    ``new_n == n_nodes`` still attaches the mask, so an exact fit shares
    its bucket's structure."""
    n = shell.n_nodes
    if new_n < n:
        raise ValueError(
            f"periphery.grow_capacity: new_n {new_n} below current shell "
            f"size {n} (capacity never shrinks)")
    dev = shell.nodes.device
    mask = torch.zeros(new_n, dtype=torch.bool, device=dev)
    mask[:n] = (shell.node_mask if shell.node_mask is not None else True)
    pad = new_n - n
    if pad == 0:
        return shell._replace(node_mask=mask)

    def pad_op(m):
        out = torch.eye(3 * new_n, dtype=m.dtype, device=m.device)
        out[:3 * n, :3 * n] = m
        return out

    return PeripheryState(
        nodes=torch.cat([shell.nodes, shell.nodes[:1].expand(pad, 3)]),
        normals=torch.cat([shell.normals, shell.normals.new_zeros((pad, 3))]),
        weights=torch.cat([shell.weights, shell.weights.new_zeros(pad)]),
        M_inv=pad_op(shell.M_inv),
        stresslet_plus_complementary=pad_op(
            shell.stresslet_plus_complementary),
        density=torch.cat([shell.density,
                           shell.density.new_zeros(3 * pad)]),
        node_mask=mask)


# ------------------------------------------------------------------ operators

def _masked_v(v_on_shell, node_mask):
    """[N, 3] shell velocities with padded rows selected to zero (the flow
    evaluators produce values at the padded placeholders)."""
    v = v_on_shell.reshape(-1, 3)
    if node_mask is None:
        return v
    return torch.where(node_mask[:, None], v, 0.0)


def matvec(shell: PeripheryState, x, v_on_shell):
    """A_shell x = (S + N) x + v; ``v_on_shell`` is [N, 3] (padded rows
    drop their v, so they stay on the identity)."""
    return (shell.stresslet_plus_complementary @ x
            + _masked_v(v_on_shell, shell.node_mask).reshape(-1))


def apply_preconditioner(shell: PeripheryState, x):
    """P^-1 x = M_inv x, applied in M_inv's (possibly lower) precision and
    cast back."""
    return (shell.M_inv @ x.to(shell.M_inv.dtype)).to(x.dtype)


def update_RHS(v_on_shell, node_mask=None):
    """RHS = -v_on_shell; padded rows (``node_mask``) get an exact-zero
    RHS, so their density solves to zero."""
    return -_masked_v(v_on_shell, node_mask).reshape(-1)


def flow(shell: PeripheryState, r_trg, density, eta, *, impl: str = "exact",
         evaluator: str = "direct", mesh=None, pair=None):
    """Shell -> target velocities through the double-layer stresslet, with
    f_dl = 2 eta n (x) rho. The shell's self-interaction is not computed
    here: `System._apply_matvec` evaluates this flow at fiber/body rows
    only, the self block living in the stored operator.

    ``pair`` (an `ops.evaluator.PairEvaluator` whose Ewald, tree or
    spectral plan covers the shell nodes and the targets) sums the double
    layer through its plan (a depth-0 tree through the dense seam at
    ``impl``).
    ``evaluator="ring"`` with a ``mesh`` rotates the shell's source blocks
    around the mesh (`parallel.ring`), the sources padded to a mesh
    multiple with far sentinel nodes (1e7) of zero density, as in the JAX
    package; the caller pads the targets. Otherwise the direct kernel
    runs."""
    rho = density.reshape(-1, 3)
    f_dl = 2.0 * eta * shell.normals[:, :, None] * rho[:, None, :]
    if pair is not None:
        return pair.stresslet(shell.nodes, r_trg, f_dl, eta, impl)
    if evaluator not in ("direct", "ring"):
        raise ValueError(f"pair evaluator {evaluator!r} needs a plan: pass "
                         "a PairEvaluator built by ops.evaluator.make_pair")
    if evaluator == "ring" and mesh is not None:
        from ..parallel import ring

        src = shell.nodes
        pad = (-src.shape[0]) % mesh.size
        if pad:
            src = torch.cat([src, torch.full((pad, 3), 1e7, dtype=src.dtype,
                                             device=src.device)])
            f_dl = torch.cat([f_dl, f_dl.new_zeros((pad, 3, 3))])
        if impl in ("df", "pallas_df"):
            return ring.ring_stresslet_df(src, r_trg, f_dl, eta, mesh=mesh,
                                          impl=impl).to(r_trg.dtype)
        return ring.ring_stresslet(src, r_trg, f_dl, eta, mesh=mesh, impl=impl)
    return kernels.stresslet_direct(shell.nodes, r_trg, f_dl, eta, impl=impl)


def flow_local(shells, r_loc, r_rep, density, eta, *, comm,
               impl: str = "exact"):
    """`flow` for the sharded step (`parallel.spmd`; the JAX package's
    `flow_local`), every argument one entry a shard: ``shells[k]`` is
    shard k's row block of the shell (nodes and normals node-aligned with
    ``density[k]``'s rows), ``comm`` the step's collective seam. As in
    `fibers.container.flow_multi_local`, ``r_loc[k]`` (shard k's resident
    rows: its fiber nodes) sums every shard's shell block around the ring,
    and ``r_rep[k]`` (replicated rows: body nodes; or ``r_rep`` None) only
    shard k's own block, a partial for the caller's ``comm.psum``. Returns
    (v_loc, v_rep partial). The shell's self-interaction is not computed:
    it lives in the dense stored operator."""
    from ..parallel.ring import ring_flow_local

    f_dl = [2.0 * eta * sh.normals[:, :, None] * d.reshape(-1, 3)[:, None, :]
            for sh, d in zip(shells, density)]
    src = [sh.nodes for sh in shells]
    v_loc = ring_flow_local("stresslet", impl, r_loc, src, f_dl, eta,
                            comm=comm, ring=True)
    v_rep = (None if r_rep is None else
             ring_flow_local("stresslet", impl, r_rep, src, f_dl, eta,
                             comm=comm, ring=False))
    return v_loc, v_rep


# ------------------------------------------------- shape-specific interactions

def _cortex(shape: PeripheryShape, points, threshold=0.0):
    """Radial cortex point of an ellipsoid shrunk by ``threshold``, for
    [..., 3] points (the reference's radial-ray comparison). The semi-axes
    stay host scalars, so nothing is copied to the card (the flight
    recorder's row makes no host sync)."""
    a, b, c = shape.abc
    r_scaled = torch.stack([points[..., 0] / a, points[..., 1] / b,
                            points[..., 2] / c], dim=-1)
    r_scaled_mag = torch.linalg.vector_norm(r_scaled, dim=-1)
    phi = torch.atan2(r_scaled[..., 1], r_scaled[..., 0] + 1e-12)
    theta = torch.arccos(torch.clamp(r_scaled[..., 2] / (1e-12 + r_scaled_mag),
                                     -1, 1))
    sin_t = torch.sin(theta)
    return torch.stack([(a - threshold) * sin_t * torch.cos(phi),
                        (b - threshold) * sin_t * torch.sin(phi),
                        (c - threshold) * torch.cos(theta)], dim=-1)


def signed_clearance(shape: PeripheryShape, points):
    """[...] signed clearance of [..., 3] points from the wall: positive
    inside, negative once a point has crossed it, so that a penetration
    shows as a magnitude (the flight recorder's ``min_clearance``,
    `obs.flight`). Sphere: ``radius - |p|``; ellipsoid: ``|r_cortex| -
    |p|`` along the radial ray of `check_collision` (exact on the axes,
    a diagnostic elsewhere); generic: +inf (no wall)."""
    if shape.kind == "sphere":
        return shape.radius - torch.linalg.vector_norm(points, dim=-1)
    if shape.kind == "ellipsoid":
        return (torch.linalg.vector_norm(_cortex(shape, points), dim=-1)
                - torch.linalg.vector_norm(points, dim=-1))
    return torch.full(points.shape[:-1], torch.inf, dtype=points.dtype,
                      device=points.device)


def check_collision(shape: PeripheryShape, points, threshold):
    """True if any of the [..., n, 3] points crosses the shell; reduces over
    the node axis, so a [nf, n, 3] batch gives [nf] (sphere: |p| >= radius -
    threshold; ellipsoid: radial comparison against the threshold-shrunk
    cortex point; generic: never)."""
    if shape.kind == "sphere":
        r2 = torch.sum(points**2, dim=-1)
        return torch.any(r2 >= (shape.radius - threshold) ** 2, dim=-1)
    if shape.kind == "ellipsoid":
        r_cortex = _cortex(shape, points, threshold)
        return torch.any(torch.sum(points**2, dim=-1)
                         >= torch.sum(r_cortex**2, dim=-1), dim=-1)
    return torch.zeros(points.shape[:-2], dtype=torch.bool,
                       device=points.device)


def fiber_steric_force(shape: PeripheryShape, points, f_0, l_0, skip_first):
    """Exponential repulsion wall force on [..., n, 3] fiber nodes (sphere
    and ellipsoid; zero for a generic shell). ``skip_first`` ([...] bool)
    masks the clamped minus-end node."""
    n = points.shape[-2]
    skip = torch.as_tensor(skip_first, device=points.device)
    mask = (torch.arange(n, device=points.device)
            >= torch.where(skip, 1, 0)[..., None])
    r_mag = torch.linalg.vector_norm(points, dim=-1)
    if shape.kind == "sphere":
        safe_r = torch.where(r_mag > 0, r_mag, 1.0)
        dr = points - points / safe_r[..., None] * shape.radius
        wall = shape.radius
    elif shape.kind == "ellipsoid":
        r_cortex = _cortex(shape, points)
        dr = points - r_cortex
        wall = torch.linalg.vector_norm(r_cortex, dim=-1)
    else:
        return torch.zeros_like(points)
    d = torch.linalg.vector_norm(dr, dim=-1)
    safe_d = torch.where(d > 0, d, 1.0)
    f = (f_0 * dr / safe_d[..., None]
         * torch.exp(-(wall - r_mag) / l_0)[..., None])
    inside = (r_mag < wall) & mask
    return torch.where(inside[..., None], f, 0.0)
