"""Slender-body-theory finite-difference fibers: operator/RHS/BC/force assembly.

Counterpart of `skellysim_tpu.fibers.fd_fiber`, whose docstrings give the
physics and the reference line numbers. There every function handles ONE
fiber and is `jax.vmap`-ed; here every function takes the fiber batch as an
explicit leading axis: positions ``x`` are [nf, n, 3], per-fiber scalars
[nf], solutions [nf, 4n] in the [x-block, y-block, z-block, T-block] layout.
The boundary-condition variants are built densely and chosen per fiber with
`torch.where` on the boolean flags, as in the JAX package. With runtime
node-padded matrices (`matrices.FibMatsRT`) the plus end is the last LIVE
node (an ``e_last`` contraction), padded solution entries solve the
identity and padded node rows contribute no velocity or error.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEFAULT_PENALTY = 500.0   # penalty_param_
DEFAULT_BETA_TSTEP = 1.0  # beta_tstep_


class FiberScalars(NamedTuple):
    """Per-fiber scalar parameters, each [nf]."""

    length: torch.Tensor
    length_prev: torch.Tensor
    bending_rigidity: torch.Tensor
    radius: torch.Tensor
    penalty: torch.Tensor
    beta_tstep: torch.Tensor
    v_growth: torch.Tensor


def sbt_constants(radius, length, eta):
    """c0 [nf], c1 (a float) of slender body theory."""
    epsilon = radius / length
    c0 = -torch.log(math.e * epsilon**2) / (8.0 * math.pi * eta)
    c1 = 2.0 / (8.0 * math.pi * eta)
    return c0, c1


def _c(v):
    """[nf] -> [nf, 1, 1] for broadcasting against [nf, n, n] blocks."""
    return v[:, None, None]


def _per_fiber(v, ndim: int):
    """A step size ``dt``, a float or one value a fiber ([nf]: the
    ensemble's members each keep their own dt), shaped to divide an
    [nf, ...] tensor of ``ndim`` dimensions."""
    if torch.is_tensor(v) and v.ndim == 1:
        return v.reshape((-1,) + (1,) * (ndim - 1))
    return v


def _last_node(mats):
    """Last-LIVE-node selector over the node axis (axis -2 of [nf, n, k],
    axis 0 of a matrix [n, n]): ``a[..., -1, :]`` with static matrices, an
    ``e_last`` contraction with runtime node-padded ones (`matrices
    .FibMatsRT`), where the last live node is data."""
    e_last = getattr(mats, "e_last", None)
    if e_last is None:
        return lambda a: a[..., -1, :]
    return lambda a: torch.einsum("n,...nk->...k", e_last.to(a.dtype), a)


def derivatives(x, length_prev, mats):
    """xs..xssss [nf, n, 3] at the previous accepted length."""
    s = _c(2.0 / length_prev)
    xs = s * (mats.D1 @ x)
    xss = s**2 * (mats.D2 @ x)
    xsss = s**3 * (mats.D3 @ x)
    xssss = s**4 * (mats.D4 @ x)
    return xs, xss, xsss, xssss


def build_A(xs, xss, xsss, dt, eta, sc: FiberScalars, mats):
    """Full (pre-BC) implicit operator A [nf, 4n, 4n]; derivative matrices
    scaled to the target length."""
    n = xs.shape[1]
    E = _c(sc.bending_rigidity)
    c0, c1 = sbt_constants(sc.radius, sc.length, eta)
    c0 = _c(c0)
    s = _c(2.0 / sc.length)
    D1, D2, D3, D4 = s * mats.D1, s**2 * mats.D2, s**3 * mats.D3, s**4 * mats.D4
    diag = torch.eye(n, dtype=torch.bool, device=xs.device)

    def col(v):
        return v[:, :, None]

    def XX(i):
        # select, not `scalar * eye` (0 * inf = NaN would leak the scalar
        # into off-diagonal slots)
        return torch.where(diag, _c(sc.beta_tstep / dt), 0.0) \
            + E * c0 * (col(1.0 + xs[:, :, i] ** 2) * D4) \
            + E * c1 * (col(1.0 - xs[:, :, i] ** 2) * D4)

    def XY(i, j):
        return E * (c0 - c1) * (col(xs[:, :, i] * xs[:, :, j]) * D4)

    def XT(i):
        return -2.0 * c0 * (col(xs[:, :, i]) * D1) \
            - (c0 + c1) * torch.diag_embed(xss[:, :, i])

    def TX(i):
        return -(c1 + 7.0 * c0) * E * (col(xss[:, :, i]) * D4) \
            - 6.0 * c0 * E * (col(xsss[:, :, i]) * D3) \
            - _c(sc.penalty) * (col(xs[:, :, i]) * D1)

    A_TT = -2.0 * c0 * D2 + (c0 + c1) * torch.diag_embed(
        torch.sum(xss**2, dim=2))

    row_x = torch.cat([XX(0), XY(0, 1), XY(0, 2), XT(0)], dim=2)
    row_y = torch.cat([XY(0, 1), XX(1), XY(1, 2), XT(1)], dim=2)
    row_z = torch.cat([XY(0, 2), XY(1, 2), XX(2), XT(2)], dim=2)
    row_t = torch.cat([TX(0), TX(1), TX(2), A_TT], dim=2)
    return torch.cat([row_x, row_y, row_z, row_t], dim=1)


def build_RHS(x, xs, xss, dt, eta, sc: FiberScalars, mats, flow=None,
              f_external=None):
    """Full (pre-BC) RHS [nf, 4n]."""
    n = x.shape[1]
    c0, c1 = sbt_constants(sc.radius, sc.length, eta)
    D1s = _c(2.0 / sc.length) * mats.D1
    s_dot = (1.0 + mats.alpha)[None, :] * (0.5 * sc.v_growth)[:, None]

    rhs_xyz = x / _per_fiber(dt, 3) + s_dot[:, :, None] * xs  # [nf, n, 3]
    rhs_T = -sc.penalty[:, None] * torch.ones(n, dtype=x.dtype,
                                              device=x.device)

    if flow is not None:
        rhs_xyz = rhs_xyz + flow
        rhs_T = rhs_T + torch.sum(xs * (D1s @ flow), dim=2)

    if f_external is not None:
        f = f_external
        xsf = torch.sum(xs * f, dim=2)[:, :, None]
        c0b = c0[:, None, None]
        rhs_xyz = rhs_xyz + c0b * (f + xs * xsf) + c1 * (f - xs * xsf)
        rhs_T = rhs_T + 2.0 * c0[:, None] * torch.sum(xs * (D1s @ f), dim=2) \
            + (c0[:, None] - c1) * torch.sum(xss * f, dim=2)

    return torch.cat([rhs_xyz[:, :, 0], rhs_xyz[:, :, 1], rhs_xyz[:, :, 2],
                      rhs_T], dim=1)


def _bc_rows(x, xs, xss, dt, eta, sc: FiberScalars, mats,
             minus_clamped, plus_pinned, v_on_fiber, f_on_fiber):
    """The 14 boundary-condition rows B [nf, 14, 4n] and their RHS [nf, 14];
    both variants of each end are built and selected per fiber."""
    nf, n = x.shape[0], x.shape[1]
    dtype, device = x.dtype, x.device
    E = sc.bending_rigidity[:, None]
    c0, _c1 = sbt_constants(sc.radius, sc.length, eta)
    c0 = c0[:, None]
    s = (2.0 / sc.length)[:, None]
    last = _last_node(mats)
    d1_0, d2_0, d3_0 = s * mats.D1[0], s**2 * mats.D2[0], s**3 * mats.D3[0]
    d1_e, d2_e, d3_e = (s * last(mats.D1), s**2 * last(mats.D2),
                        s**3 * last(mats.D3))

    zero = torch.zeros((nf, n), dtype=dtype, device=device)
    e0 = torch.zeros(n, dtype=dtype, device=device)
    e0[0] = 1.0
    if getattr(mats, "e_last", None) is None:
        ee = torch.zeros(n, dtype=dtype, device=device)
        ee[-1] = 1.0
    else:
        ee = mats.e_last.to(dtype)
    x_e, xs_e, xss_e = last(x), last(xs), last(xss)

    def row(bx=None, by=None, bz=None, bt=None):
        parts = [zero if b is None else b.expand(nf, n)
                 for b in (bx, by, bz, bt)]
        return torch.cat(parts, dim=1)

    def dot(a, b):
        return torch.sum(a * b, dim=1)

    z3 = torch.zeros((nf, 3), dtype=dtype, device=device)
    v0 = v_on_fiber[:, 0] if v_on_fiber is not None else z3
    ve = last(v_on_fiber) if v_on_fiber is not None else z3
    f0 = f_on_fiber[:, 0] if f_on_fiber is not None else z3
    fe = last(f_on_fiber) if f_on_fiber is not None else z3

    bod = (sc.beta_tstep / dt)[:, None]

    def k(v):  # [nf] -> [nf, 1]
        return v[:, None]

    # ---- minus end, first condition (rows 0-3): Velocity (clamped) vs Force
    clamped_rows = torch.stack([
        row(bx=bod * e0),
        row(by=bod * e0),
        row(bz=bod * e0),
        row(bx=6.0 * E * c0 * k(xss[:, 0, 0]) * d3_0,
            by=6.0 * E * c0 * k(xss[:, 0, 1]) * d3_0,
            bz=6.0 * E * c0 * k(xss[:, 0, 2]) * d3_0,
            bt=2.0 * c0 * d1_0),
    ], dim=1)
    clamped_rhs = torch.cat([
        x[:, 0] / _per_fiber(dt, 2),
        k(-dot(xs[:, 0], v0) - 2.0 * c0[:, 0] * dot(xs[:, 0], f0)),
    ], dim=1)
    free_rows = torch.stack([
        row(bx=E * d3_0, bt=k(-xs[:, 0, 0]) * e0),
        row(by=E * d3_0, bt=k(-xs[:, 0, 1]) * e0),
        row(bz=E * d3_0, bt=k(-xs[:, 0, 2]) * e0),
        row(bx=-E * k(xss[:, 0, 0]) * d2_0,
            by=-E * k(xss[:, 0, 1]) * d2_0,
            bz=-E * k(xss[:, 0, 2]) * d2_0,
            bt=-e0),
    ], dim=1)
    free_rhs = torch.cat([f0, k(dot(f0, xs[:, 0]))], dim=1)
    mc = minus_clamped
    rows_m1 = torch.where(mc[:, None, None], clamped_rows, free_rows)
    rhs_m1 = torch.where(mc[:, None], clamped_rhs, free_rhs)

    # ---- minus end, second condition (rows 4-6): AngularVelocity vs Torque
    angvel_rows = torch.stack([row(bx=bod * d1_0), row(by=bod * d1_0),
                               row(bz=bod * d1_0)], dim=1)
    angvel_rhs = xs[:, 0] / _per_fiber(dt, 2)
    torque0_rows = torch.stack([row(bx=d2_0), row(by=d2_0), row(bz=d2_0)],
                               dim=1)
    rows_m2 = torch.where(mc[:, None, None], angvel_rows, torque0_rows)
    rhs_m2 = torch.where(mc[:, None], angvel_rhs, z3)

    # ---- plus end, first condition (rows 7-10): Velocity (hinged) vs Force;
    # the pinned rows' beta/dt entries sit at the x/y/z blocks' last node
    pinned_rows = torch.stack([
        row(bx=bod * ee),
        row(by=bod * ee),
        row(bz=bod * ee),
        row(bx=6.0 * E * c0 * k(xss_e[:, 0]) * d3_e,
            by=6.0 * E * c0 * k(xss_e[:, 1]) * d3_e,
            bz=6.0 * E * c0 * k(xss_e[:, 2]) * d3_e,
            bt=2.0 * c0 * d1_e),
    ], dim=1)
    pinned_rhs = torch.cat([
        x_e / _per_fiber(dt, 2),
        k(-dot(xs_e, ve) - 2.0 * c0[:, 0] * dot(xs_e, fe)),
    ], dim=1)
    freep_rows = torch.stack([
        row(bx=-E * d3_e, bt=k(xs_e[:, 0]) * ee),
        row(by=-E * d3_e, bt=k(xs_e[:, 1]) * ee),
        row(bz=-E * d3_e, bt=k(xs_e[:, 2]) * ee),
        row(bx=E * k(xss_e[:, 0]) * d2_e,
            by=E * k(xss_e[:, 1]) * d2_e,
            bz=E * k(xss_e[:, 2]) * d2_e,
            bt=ee),
    ], dim=1)
    freep_rhs = torch.cat([fe, k(dot(fe, xs_e))], dim=1)
    pp = plus_pinned
    rows_p1 = torch.where(pp[:, None, None], pinned_rows, freep_rows)
    rhs_p1 = torch.where(pp[:, None], pinned_rhs, freep_rhs)

    # ---- plus end, second condition (rows 11-13): always Torque
    rows_p2 = torch.stack([row(bx=d2_e), row(by=d2_e), row(bz=d2_e)], dim=1)

    B = torch.cat([rows_m1, rows_m2, rows_p1, rows_p2], dim=1)
    B_rhs = torch.cat([rhs_m1, rhs_m2, rhs_p1, z3], dim=1)
    return B, B_rhs


def apply_bc_rectangular(A, RHS, x, xs, xss, dt, eta, sc: FiberScalars, mats,
                         minus_clamped, plus_pinned, v_on_fiber=None,
                         f_on_fiber=None):
    """Downsample A/RHS and append the 14 BC rows: [nf, 4n, 4n], [nf, 4n].
    With runtime node-padded matrices each padded solution entry's row
    becomes its P_down one-hot (an exact unit row) with a zero RHS, so
    padded entries solve the identity."""
    P = mats.P_down
    B, B_rhs = _bc_rows(x, xs, xss, dt, eta, sc, mats,
                        minus_clamped, plus_pinned, v_on_fiber, f_on_fiber)
    A_bc = torch.cat([P @ A, B], dim=1)
    RHS_bc = torch.cat([RHS @ P.T, B_rhs], dim=1)
    rm = getattr(mats, "row_mask", None)
    if rm is not None:
        unit = torch.cat([P, P.new_zeros((14, P.shape[1]))], dim=0)
        A_bc = torch.where(rm[None, :, None], A_bc, unit)
        RHS_bc = torch.where(rm[None, :], RHS_bc, 0.0)
    return A_bc, RHS_bc


def force_operator(xs, xss, eta, sc: FiberScalars, mats):
    """Force-density operator [nf, 3n, 4n]: solution -> force on nodes
    (f_i = -E x_i'''' + xss_i T + xs_i T')."""
    nf, n = xs.shape[0], xs.shape[1]
    s = _c(2.0 / sc.length)
    D1s, D4s = s * mats.D1, s**4 * mats.D4
    E = _c(sc.bending_rigidity)
    Z = torch.zeros((nf, n, n), dtype=xs.dtype, device=xs.device)

    def comp(i):
        ft = torch.diag_embed(xss[:, :, i]) + xs[:, :, i][:, :, None] * D1s
        blocks = [Z, Z, Z, ft]
        blocks[i] = -E * D4s
        return torch.cat(blocks, dim=2)

    return torch.cat([comp(0), comp(1), comp(2)], dim=1)


def matvec(A_bc, xvec, v, v_boundary, xs, sc: FiberScalars, mats, plus_pinned):
    """Per-fiber matvec [nf, 4n]: A_bc x - P_down(vT) + BC velocity couplings.

    ``v`` [nf, n, 3] is the velocity on the nodes from all hydrodynamic
    flows, ``v_boundary`` [nf, 7] the body-link rows (zeros unattached).
    """
    n = xs.shape[1]
    bc_start = 4 * n - 14
    nm = getattr(mats, "node_mask", None)
    if nm is not None:
        # padded node rows carry whatever the flows computed at their
        # placeholders; they contribute exactly zero
        v = torch.where(nm[None, :, None], v, 0.0)
    last = _last_node(mats)
    D1p = _c(2.0 / sc.length_prev) * mats.D1
    vT_tension = (D1p @ torch.sum(xs * v, dim=2)[:, :, None])[:, :, 0]
    vT = torch.cat([v[:, :, 0], v[:, :, 1], v[:, :, 2], vT_tension], dim=1)
    vT_in = torch.cat([vT @ mats.P_down.T,
                       torch.zeros((v.shape[0], 14), dtype=xvec.dtype,
                                   device=xvec.device)], dim=1)

    res = (A_bc @ xvec[:, :, None])[:, :, 0] - vT_in
    res[:, bc_start + 3] += torch.sum(v[:, 0] * xs[:, 0], dim=1)
    res[:, bc_start + 10] += torch.where(
        plus_pinned, torch.sum(last(v) * last(xs), dim=1), 0.0)
    if v_boundary is not None:
        res[:, bc_start:bc_start + 7] += v_boundary
    return res


def fiber_error(x, length, mats):
    """[nf] max_i | ||xs_i|| - 1 | — the inextensibility violation; padded
    node rows (runtime matrices), whose xs vanish, are excluded."""
    xs = _c(2.0 / length) * (mats.D1 @ x)
    err = torch.abs(torch.linalg.vector_norm(xs, dim=2) - 1.0)
    nm = getattr(mats, "node_mask", None)
    if nm is not None:
        err = torch.where(nm[None, :], err, 0.0)
    return torch.amax(err, dim=1)
