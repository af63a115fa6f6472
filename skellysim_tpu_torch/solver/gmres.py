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

    def __init__(self, b_norm, m, tol, maxiter, active):
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
        cs, sn, g = self.cs, self.sn, self.g
        for i in range(k):
            hi, hip = col[i], col[i + 1]
            col[i] = cs[i] * hi + sn[i] * hip
            col[i + 1] = -sn[i] * hi + cs[i] * hip
        denom = math.sqrt(col[k] ** 2 + col[k + 1] ** 2)
        c_new = col[k] / denom if denom > 0.0 else 1.0
        s_new = col[k + 1] / denom if denom > 0.0 else 0.0
        col[k] = denom
        col[k + 1] = 0.0
        cs[k], sn[k] = c_new, s_new
        g[k + 1] = -s_new * g[k]
        g[k] = c_new * g[k]
        self.H[:, k] = col
        done = abs(g[k + 1]) <= self.tol_abs
        self.k = k + 1
        if done or self.k >= m:
            self.state = "finish"

    def solution_coefficients(self):
        """y of the k x k back-substitution, and the cycle's implicit
        residual."""
        m, k, H, g = self.m, self.k, self.H, self.g
        y = np.zeros(m)
        for j in range(k - 1, -1, -1):
            hjj = H[j, j]
            y[j] = (g[j] - H[j, :] @ y) / (hjj if hjj != 0.0 else 1.0)
        self.resid_impl = abs(g[min(k, m)]) / self.safe_b_norm
        return y[:k]

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


def gmres_batched(matvec: Callable, b: torch.Tensor, *,
                  precond: Callable | None = None, tol: float = 1e-10,
                  restart: int = 100, maxiter: int = 1000, history: int = 0,
                  active=None) -> BatchedGmresResult:
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
    floats, and the CUDA kernels have no batching rule."""
    B, n = b.shape
    m = min(restart, maxiter)
    M = precond if precond is not None else (lambda v: v)
    act = [True] * B if active is None else [bool(a) for a in active]
    members = [_Member(bn, m, tol, maxiter, a)
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
        if live:
            z = b.new_zeros((B, n))
            for i in live:
                z[i] = V[i, members[i].k]
            W = matvec(M(z))
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
                              for hn, p in zip(norms, projs)]).cpu().numpy()
            off = 0
            for i in live:
                k = members[i].k
                size = 1 + 2 * (k + 1)
                row = host[off:off + size]
                off += size
                members[i].arnoldi(row[1:].reshape(2, k + 1), float(row[0]))
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
                     max_refine: int = 8,
                     history: int = 0) -> BatchedGmresResult:
    """`gmres_ir` for B members at once (``b`` [B, n]; the operators map
    [B, n] to [B, n]): each member refines on its own ladder, and the
    members still refining share one batched inner solve a sweep
    (`gmres_batched` with the others frozen) and one batched residual."""
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
                          restart=restart, maxiter=maxiter, active=act)
        for i in range(B):
            if act[i]:
                x[i] = x[i] + d.x[i]
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

