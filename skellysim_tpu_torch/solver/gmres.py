"""Matrix-free right-preconditioned restarted GMRES, host-driven.

Counterpart of `skellysim_tpu.solver.gmres` (sequential cycle, ``block_s=1``):
right preconditioning, ICGS orthogonalization (two classical Gram-Schmidt
passes), Givens rotations, restarts on the EXPLICIT residual ||b - A x||
recomputed at every restart boundary, the stall exit and the packed health
word. Where the JAX package keeps the control flow in `lax.while_loop`
carries so the solve stays one XLA program, here the loops run on the host:
the Krylov basis and every vector operation stay on the device, and only
the small Hessenberg/Givens arithmetic (m+1 numbers per iteration) runs in
float64 on the host. The s-step cycle (``block_s > 1``) is not ported yet
(ROADMAP.md §1 item 3).

``rdot`` is the JAX package's reduction seam: ``rdot(A, w)`` contracts the
vector axis of a basis slice ``A`` (or one vector) with ``w``; None is
``A @ w`` on one tensor, the bits of the solver before the seam. The
sharded step (`parallel.spmd`) passes its own, which sums each shard's
partial in shard order and adds the replicated tail once, with Krylov
vectors that are `parallel.spmd.ShardVec` (one tensor a shard). Those
provide the few vector operations the solver uses besides ``rdot``:
``+``, ``-``, division by a scalar, row indexing of a basis, and
``zeros_like()``, ``basis(rows)`` and ``combine(c)`` (the rows' linear
combination ``c @ V``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..guard.verdict import STAGNATION, nonfinite_word

__all__ = ["GmresResult", "gmres", "gmres_ir", "collective_rounds"]


class GmresResult(NamedTuple):
    x: torch.Tensor         # solution
    iters: int              # total inner iterations
    residual: float         # implicit (Givens) relative residual at exit
    converged: bool
    #: explicit relative residual ||b - A x|| / ||b|| after exit
    residual_true: float
    #: refinement sweeps taken (`gmres_ir` only; 0 for plain `gmres`)
    refines: int = 0
    #: restart cycles (`gmres`) or refinement sweeps (`gmres_ir`)
    cycles: int = 0
    #: the last ``history`` per-cycle rows [cumulative iters, implicit,
    #: explicit] in chronological order (a plain list), or None when off
    history: list | None = None
    #: packed health word (`guard.verdict` bit layout); 0 = healthy
    health: int = 0


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def _reductions(rdot):
    """(rdot, norm) from an optional injected reduction (the JAX package's
    `_reductions`): None keeps ``A @ w`` and `torch.linalg.vector_norm`."""
    if rdot is None:
        return (lambda A, w: A @ w), _norm
    return rdot, lambda v: math.sqrt(float(rdot(v, v)))


def _zeros_like(v):
    return torch.zeros_like(v) if torch.is_tensor(v) else v.zeros_like()


def _basis(v, rows: int):
    """A zero Krylov basis of ``rows`` vectors shaped like ``v``."""
    if torch.is_tensor(v):
        return torch.zeros((rows, v.shape[0]), dtype=v.dtype, device=v.device)
    return v.basis(rows)


def _combine(c, V):
    """``c @ V``: the combination of the basis rows ``V`` with the
    coefficients ``c`` (a tensor)."""
    return c @ V if torch.is_tensor(V) else V.combine(c)


def _arnoldi_cycle(matvec, M, x0, r0, m, tol_abs, safe_b_norm, rdot, norm):
    """One restart cycle from x0 with r0 = b - A x0; returns (x,
    implicit relative residual, inner iterations)."""
    beta = norm(r0)
    safe_beta = beta if beta > 0.0 else 1.0
    V = _basis(r0, m + 1)
    V[0] = r0 / safe_beta
    H = np.zeros((m + 1, m))
    cs = np.zeros(m)
    sn = np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta

    k = 0
    done = beta <= tol_abs
    while k < m and not done:
        w = matvec(M(V[k]))
        # ICGS: two classical Gram-Schmidt passes against V[:k+1]
        h = np.zeros(m + 1)
        for _ in range(2):
            proj = rdot(V[:k + 1], w)
            w = w - _combine(proj, V[:k + 1])
            h[:k + 1] += proj.cpu().numpy()
        h_norm = norm(w)
        h[k + 1] = h_norm
        V[k + 1] = w / (h_norm if h_norm > 0.0 else 1.0)

        # apply the accumulated Givens rotations to the new column
        for i in range(k):
            hi, hip = h[i], h[i + 1]
            h[i] = cs[i] * hi + sn[i] * hip
            h[i + 1] = -sn[i] * hi + cs[i] * hip
        # new rotation to zero h[k+1]
        denom = math.sqrt(h[k] ** 2 + h[k + 1] ** 2)
        c_new = h[k] / denom if denom > 0.0 else 1.0
        s_new = h[k + 1] / denom if denom > 0.0 else 0.0
        h[k] = denom
        h[k + 1] = 0.0
        cs[k], sn[k] = c_new, s_new
        g[k + 1] = -s_new * g[k]
        g[k] = c_new * g[k]
        H[:, k] = h
        done = abs(g[k + 1]) <= tol_abs
        k += 1

    # back-substitution on the k x k triangle
    y = np.zeros(m)
    for j in range(k - 1, -1, -1):
        hjj = H[j, j]
        y[j] = (g[j] - H[j, :] @ y) / (hjj if hjj != 0.0 else 1.0)
    yt = torch.as_tensor(y[:k], dtype=r0.dtype, device=r0.device)
    dx = M(_combine(yt, V[:k]))
    resid = abs(g[min(k, m)]) / safe_b_norm
    return x0 + dx, resid, k


def gmres(matvec: Callable, b: torch.Tensor, *, precond: Callable | None = None,
          tol: float = 1e-10, restart: int = 100, maxiter: int = 1000,
          history: int = 0, block_s: int = 1,
          rdot: Callable | None = None) -> GmresResult:
    """Solve ``matvec(x) = b`` with right-preconditioned restarted GMRES
    from a zero initial guess; acceptance on the explicit residual (see
    `skellysim_tpu.solver.gmres.gmres` for the stall rule and health bits).
    ``history=N`` keeps the last N per-cycle residual rows; ``rdot``: the
    reduction seam (module docstring)."""
    if block_s != 1:
        raise NotImplementedError(
            "gmres_block_s > 1 (the s-step cycle) is not ported yet "
            "(ROADMAP.md §1 item 3)")
    m = min(restart, maxiter)
    M = precond if precond is not None else (lambda v: v)
    rdot, norm = _reductions(rdot)

    b_norm = norm(b)
    # all-zero RHS -> solution zero, converged at once; a NaN norm fails
    # every comparison, so it lands here too and is stamped nonfinite below
    safe_b_norm = b_norm if b_norm > 0.0 else 1.0
    tol_abs = tol * safe_b_norm

    x = _zeros_like(b)
    r = b
    init = math.inf if b_norm > 0.0 else 0.0
    resid_true = prev_true = resid_impl = init
    total = cycles = 0
    health = nonfinite_word(b_norm)
    rows = []
    while (resid_true > tol and total < maxiter
           and not (resid_impl <= tol and resid_true > 0.5 * prev_true)):
        x, resid_impl, k = _arnoldi_cycle(matvec, M, x, r, m, tol_abs,
                                          safe_b_norm, rdot, norm)
        r = b - matvec(x)
        prev_true = resid_true
        resid_true = norm(r) / safe_b_norm
        health |= nonfinite_word(resid_true)
        if (resid_impl <= tol and resid_true > 0.5 * prev_true
                and resid_true > tol):
            health |= STAGNATION
        total += k
        cycles += 1
        rows.append([total, resid_impl, resid_true])
    if resid_true > tol and resid_impl > tol and total >= maxiter:
        health |= STAGNATION
    return GmresResult(x=x, iters=total, residual=resid_impl,
                       converged=(resid_true <= tol) or (resid_impl <= tol),
                       residual_true=resid_true, cycles=cycles,
                       history=rows[-history:] if history > 0 else None,
                       health=health)


def gmres_ir(matvec_hi: Callable, matvec_lo: Callable, b: torch.Tensor, *,
             precond_lo: Callable | None = None, tol: float = 1e-10,
             inner_tol: float = 1e-5, restart: int = 100, maxiter: int = 1000,
             max_refine: int = 8, history: int = 0,
             block_s: int = 1, rdot: Callable | None = None) -> GmresResult:
    """Mixed-precision GMRES with iterative refinement: solve A d = r with
    the cheap operator ``matvec_lo`` to ``inner_tol``, update x += d,
    recompute the residual with the exact operator ``matvec_hi``; repeat
    until the explicit residual meets ``tol`` (`skellysim_tpu.solver.gmres
    .gmres_ir`). ``residual`` is the explicit relative residual; ``rdot``
    serves the sweeps' norms and the inner solves (`gmres`)."""
    M = precond_lo if precond_lo is not None else (lambda v: v)
    norm = _reductions(rdot)[1]
    b_norm = norm(b)
    safe_b_norm = b_norm if b_norm > 0.0 else 1.0

    x = _zeros_like(b)
    r = b
    r_rel = math.inf if b_norm > 0.0 else 0.0
    outer = total = 0
    health = nonfinite_word(b_norm)
    rows = []
    while r_rel > tol and outer < max_refine:
        d = gmres(matvec_lo, r, precond=M, tol=inner_tol, restart=restart,
                  maxiter=maxiter, block_s=block_s, rdot=rdot)
        x = x + d.x
        r = b - matvec_hi(x)
        r_rel = norm(r) / safe_b_norm
        # the inner f32 loop stalling at its noise floor is the normal
        # mixed-precision exit: its STAGNATION bit is masked off, and
        # refinement-level stagnation is judged on the sweeps below
        health |= d.health & ~STAGNATION
        health |= nonfinite_word(r_rel)
        outer += 1
        total += d.iters
        rows.append([total, d.residual, r_rel])
    if r_rel > tol and outer >= max_refine:
        health |= STAGNATION
    return GmresResult(x=x, iters=total, residual=r_rel,
                       converged=r_rel <= tol, residual_true=r_rel,
                       refines=outer, cycles=outer,
                       history=rows[-history:] if history > 0 else None,
                       health=health)


def collective_rounds(iters, cycles, block_s: int = 1,
                      restart: int | None = None) -> int:
    """Dot-product reduction rounds one solve paid (the run-loop metrics
    field of the same name; see the JAX package's docstring)."""
    iters, cycles = int(iters), int(cycles)
    boundaries = cycles
    if restart:
        boundaries = max(boundaries, -(-iters // max(int(restart), 1)))
    if block_s <= 1:
        return 3 * iters + 2 * boundaries
    return 2 * (-(-iters // block_s)) + 2 * boundaries

