"""Experimental Chebyshev penalty fiber (integrated spectral representation).

The port's copy of `skellysim_tpu.fibers.chebyshev_fiber`, the counterpart
of the reference's header-only next-gen fiber
(`include/fiber_chebyshev_penalty_autodiff.hpp:34-271`,
`include/skelly_fiber.hpp:30-288`, `include/fiber_state.hpp`): a planar
(x, y) filament whose unknowns are the Chebyshev coefficients of the 4th
arclength derivative plus integration constants (2nd derivative for
tension), evolved with backward Euler under a penalty (approximately
inextensible) tension equation and solved with Newton iterations.

Where the reference pushes `autodiff::dual` types through the objective to
assemble the Jacobian, the objective here is a pure torch function and
`torch.func.jacfwd` gives the same Jacobian (the JAX package uses
`jax.jacfwd`). It works in float64 on the device that
`setup_solver_initialstate` resolves (the card unless asked for the CPU);
`evolve` is a Python loop of Newton steps (the JAX package's jitted
`lax.scan`). Like the reference, this discretization is not reachable from
`System` (fiber_type only accepts "FiniteDifference", `system.cpp:657-666`);
it is an experimental component exercised by its tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import chebyshev as cheb


class FiberState(NamedTuple):
    """All derivative caches of one divided state (`fiber_state.hpp:29-60`)."""

    XX: torch.Tensor
    XC: torch.Tensor
    XsC: torch.Tensor
    XssC: torch.Tensor
    XsssC: torch.Tensor
    XssssC: torch.Tensor
    YC: torch.Tensor
    YsC: torch.Tensor
    YssC: torch.Tensor
    YsssC: torch.Tensor
    YssssC: torch.Tensor
    TC: torch.Tensor
    TsC: torch.Tensor
    TssC: torch.Tensor


class BoundaryCondition(NamedTuple):
    """(X1, X2, Y1, Y2, T) rows appended to the spectral equations
    (`skelly_fiber.hpp` FiberBoundaryCondition)."""

    X1: torch.Tensor
    X2: torch.Tensor
    Y1: torch.Tensor
    Y2: torch.Tensor
    T: torch.Tensor


class FiberSolverChebyshevPenalty:
    """Discretization: N nodes for x/y, NT for tension, Neq/NeqT equations
    (`fiber_chebyshev_penalty_autodiff.hpp:41-77`)."""

    def __init__(self, n_nodes: int, n_nodes_tension: int, n_equations: int,
                 n_equations_tension: int, device=None):
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.n_nodes_tension = n_nodes_tension
        self.n_equations = n_equations
        self.n_equations_tension = n_equations_tension

        self.s = cheb.chebyshev_points(n_nodes, 0.0, 1.0)
        self.sT = cheb.chebyshev_points(n_nodes_tension, 0.0, 1.0)

        IM = np.array(cheb.integration_matrix(n_equations))
        IMT = np.array(cheb.integration_matrix(n_equations_tension))
        IM[0, :] = 0.0   # the T_0 row is fixed by the integration constant
        IMT[0, :] = 0.0
        self.IM = torch.as_tensor(IM, device=self.device)
        self.IMT = torch.as_tensor(IMT, device=self.device)

    # ------------------------------------------------------------- splitting

    def split_main(self, x):
        N, NT = self.n_nodes, self.n_nodes_tension
        return x[:N], x[N:2 * N], x[2 * N:2 * N + NT]

    # ------------------------------------------------- integration cascades

    def _integrate(self, IM, top, rat, consts, factors):
        """Repeatedly integrate ``top``; consts[-1], consts[-2], ... feed the
        T_0 coefficient of each antiderivative with the given factors
        (`IntegrateUp4`/`IntegrateUpTension2`,
        `fiber_chebyshev_penalty_autodiff.hpp:119-169`)."""
        out = []
        cur = top
        c = consts
        for factor in factors:
            cur = (IM @ cur) * rat
            cur = torch.cat([cur[:1] + factor * c[-1], cur[1:]])
            c = c[:-1]
            out.append(cur)
        return out

    def divide_and_construct(self, XX, L: float) -> FiberState:
        """State vector -> all derivative caches (`DivideAndConstruct`,
        `fiber_chebyshev_penalty_autodiff.hpp:96-117`)."""
        Neq, NeqT = self.n_equations, self.n_equations_tension
        XW, YW, TW = self.split_main(XX)
        XssssC, Dx = XW[:Neq], XW[Neq:]
        YssssC, Dy = YW[:Neq], YW[Neq:]
        TssC, Dt = TW[:NeqT], TW[NeqT:]

        rat = L / 2.0
        XsssC, XssC, XsC, XC = self._integrate(self.IM, XssssC, rat, Dx,
                                               (6.0, 2.0, 1.0, 1.0))
        YsssC, YssC, YsC, YC = self._integrate(self.IM, YssssC, rat, Dy,
                                               (6.0, 2.0, 1.0, 1.0))
        TsC, TC = self._integrate(self.IMT, TssC, rat, Dt, (1.0, 1.0))

        return FiberState(XX=XX, XC=XC, XsC=XsC, XssC=XssC, XsssC=XsssC,
                          XssssC=XssssC, YC=YC, YsC=YsC, YssC=YssC,
                          YsssC=YsssC, YssssC=YssssC, TC=TC, TsC=TsC,
                          TssC=TssC)

    @property
    def solution_size(self) -> int:
        return 2 * self.n_nodes + self.n_nodes_tension


# ---------------------------------------------------------- physics assembly

def fiber_forces(div: FiberState, odiv: FiberState, E: float, n_eq: int):
    """Euler-Bernoulli + SBT force densities (`FiberForces`,
    `skelly_fiber.hpp:36-71`)."""
    m = cheb.multiply
    FxC = (-E * div.XssssC + m(div.TC, odiv.XssC, "c", "c", "c", n_eq)
           + m(div.TsC, odiv.XsC, "c", "c", "c", n_eq))
    FyC = (-E * div.YssssC + m(div.TC, odiv.YssC, "c", "c", "c", n_eq)
           + m(div.TsC, odiv.YsC, "c", "c", "c", n_eq))
    ones = FxC.new_ones(n_eq)
    AxxF = ones + m(odiv.XsC, odiv.XsC, "c", "c", "n", n_eq)
    AxyF = m(odiv.XsC, odiv.YsC, "c", "c", "n", n_eq)
    AyyF = ones + m(odiv.YsC, odiv.YsC, "c", "c", "n", n_eq)
    AFxC = (m(AxxF, FxC, "n", "c", "c", n_eq) + m(AxyF, FyC, "n", "c", "c", n_eq))
    AFyC = (m(AxyF, FxC, "n", "c", "c", n_eq) + m(AyyF, FyC, "n", "c", "c", n_eq))
    return FxC, FyC, AFxC, AFyC


def fiber_evolution(AFxC, AFyC, div: FiberState, odiv: FiberState, UC, VC,
                    dt: float):
    """Backward-Euler evolution residuals (`FiberEvolution`,
    `skelly_fiber.hpp:75-81`)."""
    eqXC = div.XC - dt * AFxC - dt * UC - odiv.XC
    eqYC = div.YC - dt * AFyC - dt * VC - odiv.YC
    return eqXC, eqYC


def fiber_penalty_tension(div: FiberState, odiv: FiberState, UsC, VsC,
                          dt: float, n_eq_T: int):
    """Penalty tension residual (`FiberPenaltyTension`,
    `skelly_fiber.hpp:84-130`; the reference's vestigial nUsC/nVsC arguments
    are unused there and dropped here)."""
    m = cheb.multiply
    WXC = (7.0 * m(odiv.XssC, div.XssssC, "c", "c", "c", n_eq_T)
           + 6.0 * m(odiv.XsssC, div.XsssC, "c", "c", "c", n_eq_T))
    WYC = (7.0 * m(odiv.YssC, div.YssssC, "c", "c", "c", n_eq_T)
           + 6.0 * m(odiv.YsssC, div.YsssC, "c", "c", "c", n_eq_T))
    W1C = (m(odiv.XssC, odiv.XssC, "c", "c", "c", n_eq_T)
           + m(odiv.YssC, odiv.YssC, "c", "c", "c", n_eq_T))
    W2C = (m(UsC, odiv.XsC, "c", "c", "c", n_eq_T)
           + m(VsC, odiv.YsC, "c", "c", "c", n_eq_T))
    W3F = (m(odiv.XsC, div.XsC, "c", "c", "n", n_eq_T)
           + m(odiv.YsC, div.YsC, "c", "c", "n", n_eq_T)
           - div.XsC.new_ones(n_eq_T))
    W3C = cheb.f2c(W3F)
    WTC = cheb.multiply(div.TC, W1C, "c", "c", "c", n_eq_T)
    return 2.0 * div.TssC - WTC + WXC + WYC + W2C + W3C / dt


def clamped_bc(div: FiberState, odiv: FiberState, side: str, clamp_position,
               clamp_director) -> BoundaryCondition:
    """Clamped end (`ClampedBC`, `skelly_fiber.hpp:133-156`)."""
    ev = cheb.left_eval if side == "left" else cheb.right_eval
    W1 = ev(div.XsssC) * ev(odiv.XssC) + ev(div.YsssC) * ev(odiv.YssC)
    return BoundaryCondition(
        X1=ev(div.XC) - clamp_position[0], X2=ev(div.XsC) - clamp_director[0],
        Y1=ev(div.YC) - clamp_position[1], Y2=ev(div.YsC) - clamp_director[1],
        T=ev(div.TsC) + 3.0 * W1)


def free_bc(div: FiberState, side: str) -> BoundaryCondition:
    """Force/torque-free end (`FreeBC`, `skelly_fiber.hpp:159-171`)."""
    ev = cheb.left_eval if side == "left" else cheb.right_eval
    return BoundaryCondition(X1=ev(div.XssC), X2=ev(div.XsssC),
                             Y1=ev(div.YssC), Y2=ev(div.YsssC),
                             T=ev(div.TC))


def _combine(eq, *bcs):
    return torch.cat([eq, torch.stack(bcs)])


def sheer_deflection_objective(XX, solver: FiberSolverChebyshevPenalty, oldXX,
                               L: float, zeta: float, dt: float):
    """Residual of one backward-Euler step in background shear u = zeta*y
    (`SheerDeflectionObjective`, `fiber_chebyshev_penalty_autodiff.hpp:192-236`)."""
    div = solver.divide_and_construct(XX, L)
    odiv = solver.divide_and_construct(oldXX, L)

    _, _, AFxC, AFyC = fiber_forces(div, odiv, 1.0, solver.n_equations)

    UC = zeta * div.YC
    VC = torch.zeros_like(div.YC)
    UsC = zeta * div.YsC
    VsC = torch.zeros_like(div.YsC)

    teqXC, teqYC = fiber_evolution(AFxC, AFyC, div, odiv, UC, VC, dt)
    teqTC = fiber_penalty_tension(div, odiv, UsC, VsC, dt,
                                  solver.n_equations_tension)

    cpos = (0.0, 0.0)
    cdir = (0.0, 1.0)
    BCL = clamped_bc(div, odiv, "left", cpos, cdir)
    BCR = free_bc(div, "right")

    eqXC = _combine(teqXC, BCL.X1, BCL.X2, BCR.X1, BCR.X2)
    eqYC = _combine(teqYC, BCL.Y1, BCL.Y2, BCR.Y1, BCR.Y2)
    eqTC = _combine(teqTC, BCL.T, BCR.T)
    return torch.cat([eqXC, eqYC, eqTC])


# ------------------------------------------------------------ solve / evolve

def setup_solver_initialstate(N: int, L: float, device=None):
    """Solver + straight vertical fiber initial state
    (`SetupSolverInitialstate`, `fiber_chebyshev_penalty_autodiff.hpp:241-263`),
    float64 on ``device`` (None: the card)."""
    NT, Neq, NTeq = N - 2, N - 4, N - 4
    solver = FiberSolverChebyshevPenalty(N, NT, Neq, NTeq, device=device)
    init_X = np.zeros(N)
    init_Y = np.zeros(N)
    init_T = np.zeros(NT)
    init_Y[-4] = L / 2.0
    init_Y[-3] = 1.0
    XX = torch.as_tensor(np.concatenate([init_X, init_Y, init_T]),
                         device=solver.device)
    return solver, XX


def newton_step(solver: FiberSolverChebyshevPenalty, XX, oldXX, L, zeta, dt):
    """One Newton iteration XX - J^-1 F via jacfwd (the reference's
    `autodiff::jacobian` + dense inverse, `jnewton_fiberpenalty_test.cpp:34-52`)."""

    def objective(x):
        return sheer_deflection_objective(x, solver, oldXX, L, zeta, dt)

    F = objective(XX)
    J = torch.func.jacfwd(objective)(XX)
    return XX - torch.linalg.solve(J, F)


def evolve(solver: FiberSolverChebyshevPenalty, XX, *, L: float, zeta: float,
           dt: float, n_steps: int, newton_iterations: int = 1):
    """Backward-Euler time loop with single (or multi) Newton updates per step
    (`UpdateSingleNewtonBackwardEuler`, `jnewton_fiberpenalty_test.cpp:55-66`).
    Returns (final state, [n_steps] extensibility error after each step)."""
    errors = []
    x = XX
    for _ in range(n_steps):
        old = x
        for _ in range(newton_iterations):
            x = newton_step(solver, x, old, L, zeta, dt)
        errors.append(_extensibility_error_state(
            solver.divide_and_construct(x, L)))
    return x, torch.stack(errors)


def _extensibility_error_state(div: FiberState):
    m = cheb.multiply
    W = (m(div.XsC, div.XsC, "c", "c", "n") + m(div.YsC, div.YsC, "c", "c", "n")
         - 1.0)
    return torch.max(torch.abs(W))


def extricate(solver: FiberSolverChebyshevPenalty, XX, L: float):
    """(XC, YC, TC, extensibility error) (`Extricate`,
    `fiber_chebyshev_penalty_autodiff.hpp:266-274`)."""
    div = solver.divide_and_construct(XX, L)
    return div.XC, div.YC, div.TC, _extensibility_error_state(div)


def extensibility_error(solver: FiberSolverChebyshevPenalty, XX, L: float):
    """max |Xs.Xs + Ys.Ys - 1| (`ExtensibilityError`,
    `skelly_fiber.hpp:216-236`)."""
    return _extensibility_error_state(solver.divide_and_construct(XX, L))


def node_positions(solver: FiberSolverChebyshevPenalty, XX, L: float):
    """(x(s), y(s)) at the solver's Chebyshev nodes."""
    div = solver.divide_and_construct(XX, L)
    return cheb.c2f(div.XC), cheb.c2f(div.YC)
