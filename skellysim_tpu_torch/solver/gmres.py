"""Matrix-free right-preconditioned restarted GMRES, host-driven.

Counterpart of `skellysim_tpu.solver.gmres`: right preconditioning, ICGS
orthogonalization (two classical Gram-Schmidt passes), Givens rotations,
restarts on the EXPLICIT residual ||b - A x|| recomputed at every restart
boundary, the stall exit and the packed health word; and the s-step cycle
(``block_s > 1``): s monomial Krylov candidates a round, orthogonalized in
two batched Gram reductions (BCGS + Cholesky-QR, then one CGS2 pass), with
the raw Hessenberg columns recovered from the change of basis. Where the
JAX package keeps the control flow in `lax.while_loop` carries so the solve
stays one XLA program, here the loops run on the host: the Krylov basis and
every vector operation (the triangular solves of the s-step blocks
included) stay on the device, and only the small arithmetic (Hessenberg,
Givens, the s-step Grams' Cholesky factors and the column recovery) runs in
float64 on the host.

``rdot`` is the JAX package's reduction seam: ``rdot(A, w)`` contracts the
vector axis of a basis slice ``A`` (or one vector) with ``w``; None is
``A @ w`` on one tensor, the bits of the solver before the seam. The
sharded step (`parallel.spmd`) passes its own, which sums each shard's
partial in shard order and adds the replicated tail once, with Krylov
vectors that are `parallel.spmd.ShardVec` (one tensor a shard). Those
provide the few vector operations the solver uses besides ``rdot``:
``+``, ``-``, division by a scalar, row indexing of a basis, and
``zeros_like()``, ``basis(rows)``, ``combine(c)`` (the rows' linear
combination ``c @ V``) and ``apply(fn, *others)`` (``fn`` on each shard's
rows: the s-step blocks' concatenation, transpose and triangular solve).

The phase scopes are the JAX package's (`obs.profile.phase`): a Krylov
step's preconditioned matvec is ``arnoldi``, its orthogonalization
``gram``, its rotations ``givens`` (host arithmetic here), and the
refinement's high-precision residual ``refine``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..guard.verdict import BREAKDOWN, STAGNATION, nonfinite_word
from ..obs.profile import phase

__all__ = ["GmresResult", "gmres", "gmres_ir", "collective_rounds",
           "BatchedGmresResult", "gmres_batched", "gmres_ir_batched"]


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


def _apply(fn, V, *others):
    """``fn`` on a basis's rows (each shard's, for sharded vectors)."""
    return fn(V, *others) if torch.is_tensor(V) else V.apply(fn, *others)


def _coeffs(c, like):
    """Host float64 coefficients as a tensor of the vectors' dtype."""
    return torch.as_tensor(c, dtype=like.dtype, device=like.device)


def _host(t) -> np.ndarray:
    """A device tensor's values as a float64 numpy array (one transfer)."""
    return t.detach().to("cpu", torch.float64).numpy()


def _chol_ridge(S, scale, eps):
    """Cholesky of the projected candidate Gram with a noise-floor ridge
    (`skellysim_tpu.solver.gmres._chol_ridge`): the ridge sits at ``eps *
    max(scale, 1)``, added on the diagonal by a select, not ``ridge *
    eye`` (0 * inf = NaN). A factorization that fails gives NaN, as the
    JAX package's does: the cycle then rejects the block's columns and
    reports BREAKDOWN; nothing here switches to the sequential cycle (the
    guard ladder's second stage does, when armed)."""
    s = S.shape[0]
    ridge = eps * np.maximum(scale, 1.0)
    A = S + np.where(np.eye(s, dtype=bool), ridge, 0.0)
    try:
        return np.linalg.cholesky(A)
    except np.linalg.LinAlgError:
        return np.full_like(A, np.nan)


def _givens_col(j, hcol, cs, sn, g):
    """Apply the accumulated rotations to column ``hcol`` and add the one
    that zeroes its entry ``j + 1``; returns new (hcol, cs, sn, g)."""
    hcol, cs, sn, g = hcol.copy(), cs.copy(), sn.copy(), g.copy()
    for i in range(j):
        hi, hip = hcol[i], hcol[i + 1]
        hcol[i] = cs[i] * hi + sn[i] * hip
        hcol[i + 1] = -sn[i] * hi + cs[i] * hip
    denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
    c_new = hcol[j] / denom if denom > 0.0 else 1.0
    s_new = hcol[j + 1] / denom if denom > 0.0 else 0.0
    hcol[j] = denom
    hcol[j + 1] = 0.0
    cs[j], sn[j] = c_new, s_new
    g[j + 1] = -s_new * g[j]
    g[j] = c_new * g[j]
    return hcol, cs, sn, g


class _BlockCycle:
    """The host side of one s-step restart cycle (the JAX package's
    `arnoldi_cycle_block` carries): the raw and rotated Hessenberg columns,
    the rotations, the residual vector g, the breakdown flag. A round
    runs `gram1` on the BCGS Gram, `gram2` on the CGS2 Gram, then
    `recover` the s columns."""

    def __init__(self, m, s, beta, tol_abs, dtype):
        self.m, self.s, self.tol_abs = m, s, tol_abs
        fi = torch.finfo(dtype)
        self.eps, self.tiny = fi.eps, fi.tiny
        self.rows = float(m + 1 + s)
        self.Hr = np.zeros((m + 1, m))
        self.H = np.zeros((m + 1, m))
        self.cs = np.zeros(m)
        self.sn = np.zeros(m)
        self.g = np.zeros(m + 1)
        self.g[0] = beta
        self.k = 0
        self.brk = False
        self.done = beta <= tol_abs

    @property
    def live(self) -> bool:
        return self.k < self.m and not self.done

    def gram1(self, G):
        """BCGS + Cholesky-QR on the first Gram ``G`` [(k+1)+s, s] of
        [V[:k+1]; P] against P: returns (C1^T, L1), the projection
        coefficients and the factor to apply to the candidates
        (Q1 = L1^-1 (P - C1^T V))."""
        k = self.k
        C1, S1 = G[:k + 1], G[k + 1:]
        self.scale1 = self.rows * np.max(np.diagonal(S1))
        self.C1 = C1
        self.L1 = _chol_ridge(S1 - C1.T @ C1, self.scale1, self.eps)
        return C1.T, self.L1

    def gram2(self, G2):
        """The CGS2 pass on the second Gram: returns (C2^T, L2)."""
        k = self.k
        C2, S2 = G2[:k + 1], G2[k + 1:]
        L2 = _chol_ridge(S2 - C2.T @ C2, self.rows * np.max(np.diagonal(S2)),
                         self.eps)
        # the change of basis over both passes:
        #   p_j = C[:, j] . V  +  sum_u Rm[u, j] q_u
        self.C = self.C1 + C2 @ self.L1.T
        self.Rm = (self.L1 @ L2).T
        return C2.T, L2

    def recover(self):
        """Recover the round's s raw Hessenberg columns, rotate each as
        the sequential cycle does, and accept them up to the first
        breakdown or convergence (JAX `arnoldi_cycle_block`, the
        Hoemmen-style recovery)."""
        m, k, s = self.m, self.k, self.s
        # below the projected Gram's noise floor the recovered direction is
        # cancellation noise: end the cycle there
        tiny = math.sqrt(self.eps * self.scale1) + self.tiny
        C = np.zeros((m + 1, s))
        C[:k + 1] = self.C
        accepted = 0
        prev_e = np.zeros(m + 1)
        for t in range(s):
            j = k + t
            e_t = C[:, t].copy()
            e_t[k + 1:k + 1 + s] += self.Rm[:, t]
            if t == 0:
                hraw, rdiag = e_t, 1.0
            else:
                rdiag = prev_e[j]
                coef = prev_e.copy()
                coef[j] = 0.0
                hraw = ((e_t - self.Hr @ coef[:m])
                        / (rdiag if rdiag > tiny else 1.0))
            col_ok = bool(np.all(np.isfinite(hraw))) and rdiag > tiny
            acc = not self.done and col_ok
            # a rejected column while the cycle was live is the
            # Cholesky-ridge breakdown the health word reports
            self.brk = self.brk or (not self.done and not col_ok)
            if acc:
                hrot, self.cs, self.sn, self.g = _givens_col(
                    j, hraw, self.cs, self.sn, self.g)
                self.Hr[:, j] = hraw
                self.H[:, j] = hrot
                accepted += 1
            self.done = (self.done or not col_ok
                         or (acc and abs(self.g[j + 1]) <= self.tol_abs))
            prev_e = e_t
        self.k = k + accepted

    def solution_coefficients(self):
        """y of the k x k back-substitution."""
        return _back_substitute(self.H, self.g, self.k, self.m)


def _back_substitute(H, g, k, m):
    """y[:k] of the k x k triangular system H y = g."""
    y = np.zeros(m)
    for j in range(k - 1, -1, -1):
        hjj = H[j, j]
        y[j] = (g[j] - H[j, :] @ y) / (hjj if hjj != 0.0 else 1.0)
    return y[:k]


def _cat_rows(A, B):
    return torch.cat([A, B])


def _transpose(A):
    return A.T


def _finite_or_zero(Q):
    # a fully dependent candidate block can leave NaN rows (0/0 through the
    # triangular solves); they are never accepted, but must not poison V
    return torch.where(torch.isfinite(Q), Q, 0.0)


def _solve_lower(L):
    """``W -> L^-1 W`` for a host lower-triangular ``L`` (s x s) by forward
    substitution over W's s rows, each a vector operation on W's device
    (`torch.linalg.solve_triangular` took seconds a call on the card at
    [4, 560k]). A NaN or zero pivot gives nonfinite rows, as the JAX
    package's triangular solve does."""
    def solve(W):
        Q = torch.empty_like(W)
        for j in range(L.shape[0]):
            acc = W[j]
            for i in range(j):
                acc = acc - float(L[j, i]) * Q[i]
            Q[j] = acc / float(L[j, j])
        return Q
    return solve


def _block_rounds(rounds, grams):
    """The two Gram passes of one s-step round and the basis update, for
    each ``(cyc, V, P)`` of ``rounds``: ``P`` holds the round's s
    candidates; V[k+1:k+1+s] receives the orthonormal block; the host
    records the Grams' factors (``cyc``), whose `recover` then turns them
    into the round's columns. ``grams`` maps a list of (V[:k+1], Q) to the
    host Grams [V[:k+1]; Q] Q^T, all in one reduction: the BCGS Gram, then
    the CGS2 pass."""
    Q1 = []
    for (cyc, V, P), G in zip(rounds, grams([(V[:cyc.k + 1], P)
                                             for cyc, V, P in rounds])):
        C1t, L1 = cyc.gram1(G)
        W = P - _combine(_coeffs(C1t, P), V[:cyc.k + 1])
        Q1.append(_apply(_solve_lower(L1), W))
    G2s = grams([(V[:cyc.k + 1], Q) for (cyc, V, _), Q in zip(rounds, Q1)])
    for (cyc, V, _), Q, G2 in zip(rounds, Q1, G2s):
        k = cyc.k
        C2t, L2 = cyc.gram2(G2)
        W2 = Q - _combine(_coeffs(C2t, Q), V[:k + 1])
        V[k + 1:k + 1 + cyc.s] = _apply(_finite_or_zero,
                                        _apply(_solve_lower(L2), W2))


def _rdot_grams(rdot):
    """`_block_rounds`'s ``grams`` through the ``rdot`` seam (one lone
    cycle: one batched reduction a pass)."""
    return lambda pairs: [
        _host(rdot(_apply(_cat_rows, Vk, Q), _apply(_transpose, Q)))
        for Vk, Q in pairs]


def _arnoldi_cycle_block(matvec, M, x0, r0, m, s, tol_abs, safe_b_norm,
                         rdot, norm):
    """One communication-avoiding restart cycle (``block_s = s > 1``):
    returns (x, implicit relative residual, inner iterations, breakdown).
    Each round generates the monomial candidates p_j = (A M)^j v_k (s
    matvecs), orthogonalizes them in two batched Gram reductions through
    ``rdot`` and recovers the raw Hessenberg columns on the host."""
    beta = norm(r0)
    safe_beta = beta if beta > 0.0 else 1.0
    V = _basis(r0, m + 1)
    V[0] = r0 / safe_beta
    cyc = _BlockCycle(m, s, beta, tol_abs, r0.dtype)
    while cyc.live:
        with phase("arnoldi"):
            P = _basis(r0, s)
            prev = V[cyc.k]
            for j in range(s):
                P[j] = matvec(M(prev))
                prev = P[j]
        with phase("gram"):
            _block_rounds([(cyc, V, P)], _rdot_grams(rdot))
        with phase("givens"):
            cyc.recover()
    k = cyc.k
    yt = torch.as_tensor(cyc.solution_coefficients(), dtype=r0.dtype,
                         device=r0.device)
    dx = M(_combine(yt, V[:k]))
    resid = abs(cyc.g[min(k, m)]) / safe_b_norm
    return x0 + dx, resid, k, cyc.brk


def _arnoldi_cycle(matvec, M, x0, r0, m, tol_abs, safe_b_norm, rdot, norm):
    """One restart cycle from x0 with r0 = b - A x0; returns (x,
    implicit relative residual, inner iterations, breakdown=False: only
    the s-step cycle has a breakdown path)."""
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
        with phase("arnoldi"):
            w = matvec(M(V[k]))
        with phase("gram"):
            # ICGS: two classical Gram-Schmidt passes against V[:k+1]
            h = np.zeros(m + 1)
            for _ in range(2):
                proj = rdot(V[:k + 1], w)
                w = w - _combine(proj, V[:k + 1])
                h[:k + 1] += proj.cpu().numpy()
            h_norm = norm(w)
            h[k + 1] = h_norm
            V[k + 1] = w / (h_norm if h_norm > 0.0 else 1.0)

        with phase("givens"):
            H[:, k], cs, sn, g = _givens_col(k, h, cs, sn, g)
        done = abs(g[k + 1]) <= tol_abs
        k += 1

    yt = torch.as_tensor(_back_substitute(H, g, k, m), dtype=r0.dtype,
                         device=r0.device)
    dx = M(_combine(yt, V[:k]))
    resid = abs(g[min(k, m)]) / safe_b_norm
    return x0 + dx, resid, k, False


def gmres(matvec: Callable, b: torch.Tensor, *, precond: Callable | None = None,
          tol: float = 1e-10, restart: int = 100, maxiter: int = 1000,
          history: int = 0, block_s: int = 1,
          rdot: Callable | None = None) -> GmresResult:
    """Solve ``matvec(x) = b`` with right-preconditioned restarted GMRES
    from a zero initial guess; acceptance on the explicit residual (see
    `skellysim_tpu.solver.gmres.gmres` for the stall rule and health bits).
    ``history=N`` keeps the last N per-cycle residual rows; ``rdot``: the
    reduction seam (module docstring). ``block_s=s > 1`` runs the s-step
    cycle (`_arnoldi_cycle_block`: two batched reductions through ``rdot``
    a round of s iterations), with the restart length rounded up to a
    multiple of s; ``block_s=1`` is the sequential cycle."""
    if block_s < 1:
        raise ValueError(f"block_s must be >= 1, got {block_s}")
    m = min(restart, maxiter)
    if block_s > 1:
        # full rounds only (the overshoot past maxiter is at most s - 1)
        m = -(-m // block_s) * block_s
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
        if block_s > 1:
            x, resid_impl, k, brk = _arnoldi_cycle_block(
                matvec, M, x, r, m, block_s, tol_abs, safe_b_norm, rdot,
                norm)
        else:
            x, resid_impl, k, brk = _arnoldi_cycle(
                matvec, M, x, r, m, tol_abs, safe_b_norm, rdot, norm)
        r = b - matvec(x)
        prev_true = resid_true
        resid_true = norm(r) / safe_b_norm
        health |= nonfinite_word(resid_true)
        if brk:
            health |= BREAKDOWN
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
        # the high-precision residual matvec, the sweep's dominant cost
        with phase("refine"):
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


# ------------------------------------------------------- member batches

class BatchedGmresResult(NamedTuple):
    """`GmresResult` of B members: ``x`` [B, n], every other field a list
    of B per-member values."""
    x: torch.Tensor
    iters: list
    residual: list
    converged: list
    residual_true: list
    refines: list
    cycles: list
    history: list | None
    health: list

    def member(self, i: int) -> GmresResult:
        """Member ``i``'s `GmresResult`."""
        return GmresResult(
            x=self.x[i], iters=self.iters[i], residual=self.residual[i],
            converged=self.converged[i],
            residual_true=self.residual_true[i], refines=self.refines[i],
            cycles=self.cycles[i],
            history=None if self.history is None else self.history[i],
            health=self.health[i])


def _row_norms(v) -> list:
    """The [B] vector norms of the rows of ``v`` as floats (one transfer)."""
    return torch.linalg.vector_norm(v, dim=1).tolist()


class _Member:
    """One member's restarted-GMRES state between batched rounds: the host
    scalars of `gmres` and of the open `_arnoldi_cycle`."""

    def __init__(self, b_norm, m, tol, maxiter, active, block_s=1,
                 dtype=torch.float64):
        self.block_s = block_s
        self.dtype = dtype
        self.b_norm = b_norm
        self.safe_b_norm = b_norm if b_norm > 0.0 else 1.0
        self.tol_abs = tol * self.safe_b_norm
        init = math.inf if b_norm > 0.0 else 0.0
        self.resid_true = self.prev_true = self.resid_impl = init
        self.total = self.cycles = 0
        self.health = nonfinite_word(b_norm)
        self.rows = []
        self.m = m
        self.tol = tol
        self.maxiter = maxiter
        self.state = "check" if active else "frozen"
        self.beta = b_norm

    def wants_cycle(self) -> bool:
        return (self.resid_true > self.tol and self.total < self.maxiter
                and not (self.resid_impl <= self.tol
                         and self.resid_true > 0.5 * self.prev_true))

    def open_cycle(self):
        m = self.m
        if self.block_s > 1:
            self.cyc = _BlockCycle(m, self.block_s, self.beta, self.tol_abs,
                                   self.dtype)
            self.k = 0
            self.state = "arnoldi" if self.cyc.live else "finish"
            return
        self.H = np.zeros((m + 1, m))
        self.cs = np.zeros(m)
        self.sn = np.zeros(m)
        self.g = np.zeros(m + 1)
        self.g[0] = self.beta
        self.k = 0
        done = self.beta <= self.tol_abs
        self.state = "finish" if done or m == 0 else "arnoldi"

    def arnoldi(self, h, h_norm):
        """The Givens update of one Arnoldi column (``h`` the two ICGS
        passes' projections, summed as `_arnoldi_cycle` sums them)."""
        m, k = self.m, self.k
        col = np.zeros(m + 1)
        for proj in h:
            col[:k + 1] += proj
        col[k + 1] = h_norm
        self.H[:, k], self.cs, self.sn, self.g = _givens_col(
            k, col, self.cs, self.sn, self.g)
        done = abs(self.g[k + 1]) <= self.tol_abs
        self.k = k + 1
        if done or self.k >= m:
            self.state = "finish"

    def block_done(self):
        """After an s-step round: the cycle ends where its host state
        stopped (`_BlockCycle.live`)."""
        self.k = self.cyc.k
        if not self.cyc.live:
            self.state = "finish"

    def solution_coefficients(self):
        """y of the k x k back-substitution, and the cycle's implicit
        residual."""
        m = self.m
        if self.block_s > 1:
            self.k, self.H, self.g = self.cyc.k, self.cyc.H, self.cyc.g
            if self.cyc.brk:
                self.health |= BREAKDOWN
        self.resid_impl = abs(self.g[min(self.k, m)]) / self.safe_b_norm
        return _back_substitute(self.H, self.g, self.k, m)

    def close_cycle(self, r_norm):
        self.prev_true = self.resid_true
        self.resid_true = r_norm / self.safe_b_norm
        self.health |= nonfinite_word(self.resid_true)
        if (self.resid_impl <= self.tol
                and self.resid_true > 0.5 * self.prev_true
                and self.resid_true > self.tol):
            self.health |= STAGNATION
        self.total += self.k
        self.cycles += 1
        self.rows.append([self.total, self.resid_impl, self.resid_true])
        self.beta = r_norm
        self.state = "check"

    def result_health(self) -> int:
        if (self.resid_true > self.tol and self.resid_impl > self.tol
                and self.total >= self.maxiter):
            return self.health | STAGNATION
        return self.health


def _host_rows(parts) -> list:
    """Host float64 copies of a list of device tensors, one transfer."""
    if not parts:
        return []
    flat = _host(torch.cat([p.reshape(-1) for p in parts]))
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def _batched_block_round(matvec, M, b, V, members, live, s):
    """One s-step round for the ``live`` members of `gmres_batched`: s
    batched matvecs for the candidates, then each member's two Grams
    (one host transfer for all members a pass) and its column recovery
    (`_block_rounds`)."""
    B, n = b.shape
    z = b.new_zeros((B, n))
    for i in live:
        z[i] = V[i, members[i].cyc.k]
    P = b.new_zeros((B, s, n))
    with phase("arnoldi"):
        for j in range(s):
            W = matvec(M(z))
            z = b.new_zeros((B, n))
            for i in live:
                P[i, j] = W[i]
                z[i] = W[i]

    def grams(pairs):
        return _host_rows([torch.cat([Vk, Q]) @ Q.T for Vk, Q in pairs])

    with phase("gram"):
        _block_rounds([(members[i].cyc, V[i], P[i]) for i in live], grams)
    with phase("givens"):
        for i in live:
            members[i].cyc.recover()
            members[i].block_done()


def gmres_batched(matvec: Callable, b: torch.Tensor, *,
                  precond: Callable | None = None, tol: float = 1e-10,
                  restart: int = 100, maxiter: int = 1000, history: int = 0,
                  active=None, block_s: int = 1) -> BatchedGmresResult:
    """`gmres` for B members at once: ``b`` is [B, n], and ``matvec`` /
    ``precond`` map [B, n] to [B, n] (every member in one call). Each
    member keeps its own Krylov basis, Givens rotations, restarts,
    acceptance and health word, and steps through exactly the operations
    its solo `gmres` would: a member that is done is frozen (its rows of
    the batched calls are discarded), so its ``x``, ``iters``, residuals
    and health are its solo solve's (to the batched operator's roundoff).
    The host reads the members' projections and norms once an Arnoldi step
    for all members, and once at every restart boundary. ``active`` ([B]
    bools, default all) freezes the others from the start (x = 0, 0
    iterations). `torch.func.vmap` cannot serve: the cycle decides on host
    floats, and the CUDA kernels have no batching rule. ``block_s > 1``:
    each member runs the s-step cycle (`gmres`), the live members sharing
    the s batched matvecs of a round."""
    if block_s < 1:
        raise ValueError(f"block_s must be >= 1, got {block_s}")
    B, n = b.shape
    m = min(restart, maxiter)
    if block_s > 1:
        m = -(-m // block_s) * block_s
    M = precond if precond is not None else (lambda v: v)
    act = [True] * B if active is None else [bool(a) for a in active]
    members = [_Member(bn, m, tol, maxiter, a, block_s, b.dtype)
               for bn, a in zip(_row_norms(b), act)]
    x = torch.zeros_like(b)
    r = b.clone()
    V = b.new_zeros((B, m + 1, n))
    while True:
        for i, mb in enumerate(members):
            if mb.state == "check":
                if mb.wants_cycle():
                    safe_beta = mb.beta if mb.beta > 0.0 else 1.0
                    V[i, 0] = r[i] / safe_beta
                    mb.open_cycle()
                else:
                    mb.state = "done"
        live = [i for i, mb in enumerate(members) if mb.state == "arnoldi"]
        if live and block_s > 1:
            _batched_block_round(matvec, M, b, V, members, live, block_s)
        elif live:
            with phase("arnoldi"):
                z = b.new_zeros((B, n))
                for i in live:
                    z[i] = V[i, members[i].k]
                W = matvec(M(z))
            with phase("gram"):
                projs, norms = [], []
                for i in live:
                    k = members[i].k
                    w, Vk = W[i], V[i, :k + 1]
                    passes = []
                    for _ in range(2):
                        proj = Vk @ w
                        w = w - proj @ Vk
                        passes.append(proj)
                    h_norm = torch.linalg.vector_norm(w)
                    V[i, k + 1] = w / torch.where(h_norm > 0.0, h_norm, 1.0)
                    projs.append(torch.stack(passes))
                    norms.append(h_norm)
                # one transfer for every member of this Arnoldi step
                host = torch.cat([torch.cat([hn.reshape(1), p.reshape(-1)])
                                  for hn, p in zip(norms, projs)]
                                 ).cpu().numpy()
            with phase("givens"):
                off = 0
                for i in live:
                    k = members[i].k
                    size = 1 + 2 * (k + 1)
                    row = host[off:off + size]
                    off += size
                    members[i].arnoldi(row[1:].reshape(2, k + 1),
                                       float(row[0]))
        closing = [i for i, mb in enumerate(members) if mb.state == "finish"]
        if closing:
            z = b.new_zeros((B, n))
            for i in closing:
                mb = members[i]
                y = mb.solution_coefficients()
                yt = torch.as_tensor(y, dtype=b.dtype, device=b.device)
                z[i] = yt @ V[i, :mb.k]
            dx = M(z)
            for i in closing:
                x[i] = x[i] + dx[i]
            r_new = b - matvec(x)
            for i in closing:
                r[i] = r_new[i]
            norms = _row_norms(r_new)
            for i in closing:
                members[i].close_cycle(norms[i])
        if not live and not closing:
            break
    return BatchedGmresResult(
        x=x, iters=[mb.total for mb in members],
        residual=[mb.resid_impl for mb in members],
        converged=[(mb.resid_true <= tol) or (mb.resid_impl <= tol)
                   for mb in members],
        residual_true=[mb.resid_true for mb in members],
        refines=[0] * B, cycles=[mb.cycles for mb in members],
        history=([mb.rows[-history:] for mb in members] if history > 0
                 else None),
        health=[mb.result_health() for mb in members])


def gmres_ir_batched(matvec_hi: Callable, matvec_lo: Callable,
                     b: torch.Tensor, *, precond_lo: Callable | None = None,
                     tol: float = 1e-10, inner_tol: float = 1e-5,
                     restart: int = 100, maxiter: int = 1000,
                     max_refine: int = 8, history: int = 0,
                     block_s: int = 1) -> BatchedGmresResult:
    """`gmres_ir` for B members at once (``b`` [B, n]; the operators map
    [B, n] to [B, n]): each member refines on its own ladder, and the
    members still refining share one batched inner solve a sweep
    (`gmres_batched` with the others frozen, ``block_s`` passed on) and
    one batched residual."""
    B = b.shape[0]
    b_norm = _row_norms(b)
    safe = [bn if bn > 0.0 else 1.0 for bn in b_norm]
    x = torch.zeros_like(b)
    r = b.clone()
    r_rel = [math.inf if bn > 0.0 else 0.0 for bn in b_norm]
    outer, total = [0] * B, [0] * B
    health = [nonfinite_word(bn) for bn in b_norm]
    rows = [[] for _ in range(B)]
    while True:
        act = [r_rel[i] > tol and outer[i] < max_refine for i in range(B)]
        if not any(act):
            break
        d = gmres_batched(matvec_lo, r, precond=precond_lo, tol=inner_tol,
                          restart=restart, maxiter=maxiter, active=act,
                          block_s=block_s)
        for i in range(B):
            if act[i]:
                x[i] = x[i] + d.x[i]
        with phase("refine"):
            r_new = b - matvec_hi(x)
            norms = _row_norms(r_new)
        for i in range(B):
            if not act[i]:
                continue
            r[i] = r_new[i]
            r_rel[i] = norms[i] / safe[i]
            health[i] |= d.health[i] & ~STAGNATION
            health[i] |= nonfinite_word(r_rel[i])
            outer[i] += 1
            total[i] += d.iters[i]
            rows[i].append([total[i], d.residual[i], r_rel[i]])
    for i in range(B):
        if r_rel[i] > tol and outer[i] >= max_refine:
            health[i] |= STAGNATION
    return BatchedGmresResult(
        x=x, iters=total, residual=r_rel,
        converged=[rr <= tol for rr in r_rel], residual_true=r_rel,
        refines=outer, cycles=list(outer),
        history=[rw[-history:] for rw in rows] if history > 0 else None,
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



# ---------------------------------------------------------------- the registry

def auditable_programs():
    """The solver layer's registry entry: a bare f32 GMRES solve on a
    dense well-conditioned 64 x 64 operator, the program the
    mixed-precision path embeds as its Krylov inner loop (the JAX
    package's ``gmres_f32``)."""
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice

    def build(device=None):
        from ..device import resolve_device

        dev = resolve_device(device)
        rng = np.random.default_rng(11)
        n = 64
        A = torch.as_tensor(np.eye(n) + 0.1 * rng.standard_normal((n, n)),
                            dtype=torch.float32, device=dev)
        b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        return BuiltProgram(_registered_solve, (A, b), device=dev)

    def retrace_probe(device=None):
        # a second right-hand side of the same shape
        built = build(device)
        A, b = built.args
        return probe_twice(lambda: _registered_solve(A, b),
                           lambda _: _registered_solve(A, 1.5 * b + 0.25))

    return [AuditProgram(
        name="gmres_f32", layer="solver",
        summary="bare f32 GMRES on a dense 64x64 operator (the mixed "
                "path's Krylov inner loop)",
        build=build, retrace_probe=retrace_probe)]


def _registered_solve(A, b):
    return gmres(lambda x: A @ x, b, tol=1e-4, restart=32, maxiter=64)
