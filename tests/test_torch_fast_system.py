"""The port's `System` under the fast evaluators against the JAX package's.

One "full" f64 step from the same state in both packages, the same plan
built on each side (`make_ewald_plan` / `make_spectral_plan` give equal
plans), solutions equal to 1e-10 of their largest entry:

* free fibers under "ewald";
* the same fibers grown to three times their slots by `grow_capacity`
  (two thirds inactive, re-spread onto the plan's fill positions);
* fibers bound to a body inside a small shell, ``ewald_min_sources = 0``
  so the shell's and the body's double layers take the Ewald stresslet;
* free fibers in a triply periodic box under "spectral";
* free fibers under "tree" (a depth-2 treecode), in "full" and in
  "mixed" (positions to 1e-10), and the coupled shell-and-body scene with
  its double layers through the tree stresslet.

Then a "mixed" step under a coarse Ewald tolerance refines to gmres_tol
(the f64 residual stays dense) and agrees with the JAX package's to 1e-8;
a "mixed" step under "spectral" refines on the periodic operator (the
port's own, held to its "full" step: the JAX package's dense residual is
the free-space one); and a config that says ``pair_evaluator = "FMM"`` runs through the port's
CLI and the JAX package's to the same frames, as does one that says
``pair_evaluator = "tree"``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.system import BackgroundFlow as JBackground
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch import convert
from skellysim_tpu_torch import testing as ttesting
from skellysim_tpu_torch.system import System


def _leaves(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


def _fibers(n_fib=8, n_nodes=16, seed=29, lo=-2.0, hi=2.0, length=1.0,
            curvature=0.5):
    """Circular arcs of the given curvature (exact arclength; 0: straight
    lines). Straight fibers under a uniform tangential force or flow carry
    no implicit force, so their pair flows vanish from the solution
    (`test_straight_fibers_leave_the_solve_uncoupled`)."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(lo, hi, (n_fib, 3))
    dirs = rng.normal(size=(n_fib, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    perp = np.cross(dirs, rng.normal(size=(n_fib, 3)))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    t = np.linspace(0, length, n_nodes)[None, :, None]
    if curvature:
        R = 1.0 / curvature
        x = (origins[:, None, :] + R * np.sin(t / R) * dirs[:, None, :]
             + R * (1.0 - np.cos(t / R)) * perp[:, None, :])
    else:
        x = origins[:, None, :] + t * dirs[:, None, :]
    return jfc.make_group(x, lengths=length, bending_rigidity=0.01,
                          radius=0.0125, force_scale=-0.05)


def _port(jsys, jstate, shape=None):
    """The port's System and state from the JAX package's."""
    from skellysim_tpu_torch.periphery import periphery as tperi

    tsys = System(convert.params_from_dict(dataclasses.asdict(jsys.params)),
                  shell_shape=(None if shape is None else tperi.PeripheryShape(
                      **dataclasses.asdict(shape))), device="cpu")
    bg = jstate.background
    tstate = convert.state_from_numpy(
        _leaves(jstate.fibers), time=float(jstate.time), dt=float(jstate.dt),
        background=None if bg is None else _leaves(bg),
        shell=None if jstate.shell is None else _leaves(jstate.shell),
        bodies=(None if jstate.bodies is None
                else _leaves(jstate.bodies)
                if hasattr(jstate.bodies, "_asdict")
                else [_leaves(g) for g in jstate.bodies]),
        device="cpu")
    return tsys, tstate


def _same_plan(jsys, jstate, tsys, tstate):
    make = {"ewald": "make_ewald_plan", "tree": "make_tree_plan",
            "spectral": "make_spectral_plan"}[jsys.params.pair_evaluator]
    jp = getattr(jsys, make)(jstate)
    tp = getattr(tsys, make)(tstate)
    assert tp.__dict__ == jp.__dict__
    return tp


def _step_both(jsys, jstate, shape=None, tol=1e-10):
    tsys, tstate = _port(jsys, jstate, shape)
    plan = _same_plan(jsys, jstate, tsys, tstate)
    jnew, jsol, jinfo = jsys.step(jstate)
    tnew, tsol, tinfo = tsys.step(tstate)
    assert tinfo.converged and bool(jinfo.converged)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=tol * np.abs(jsol).max())
    np.testing.assert_allclose(tnew.fibers.x.numpy(),
                               np.asarray(jnew.fibers.x), rtol=0, atol=tol)
    return plan, tsys, tstate, tsol, tinfo


_BASE = dict(eta=1.0, dt_initial=1e-3, gmres_tol=1e-10,
             adaptive_timestep_flag=False, pair_evaluator="ewald",
             ewald_tol=1e-7)


@pytest.fixture(scope="module")
def ewald_fibers():
    """The fibers' Ewald step in both packages, held against each other
    once for the module: (JAX system, fibers, background, the step's
    `_step_both` result)."""
    jsys = JSystem(JParams(**_BASE))
    fibers = _fibers()
    bg = JBackground.make(uniform=(1.0, 0.0, 0.0))
    return jsys, fibers, bg, _step_both(
        jsys, jsys.make_state(fibers=fibers, background=bg))


def test_fibers_ewald_step_matches_jax(ewald_fibers):
    plan = ewald_fibers[3][0]
    assert plan.near_mode == "cells"


def test_inactive_padding_is_spread_and_matches_jax(ewald_fibers):
    """`grow_capacity` padding (inactive slots replicating slot 0): the
    plan reserves fill capacity for the inactive nodes instead of one hot
    cell, the step matches the JAX package's, and the live part of the
    solution is the unpadded one's."""
    jsys, fibers, bg, (_, _, _, sol_ref, _) = ewald_fibers
    grown = jfc.grow_capacity(fibers, 3 * fibers.n_fibers)
    jstate = jsys.make_state(fibers=grown, background=bg)
    plan, tsys, tstate, sol, _ = _step_both(jsys, jstate)
    plan_ref = tsys.make_ewald_plan(tsys.make_state(
        fibers=convert.group_from_numpy(_leaves(fibers), device="cpu")))
    assert plan.max_occ <= 4 * plan_ref.max_occ
    n_live = sol_ref.shape[0]
    assert (np.linalg.norm(sol[:n_live].numpy() - sol_ref.numpy())
            / np.linalg.norm(sol_ref.numpy())) < 1e-6


def test_shell_and_body_double_layers_through_ewald_match_jax():
    """ewald_min_sources = 0: the shell's and the body's double layers
    (matvec and Gauss-Seidel correction) take the Ewald stresslet."""
    _shell_and_body_step("ewald")


def test_shell_and_body_double_layers_through_tree_match_jax():
    """The same through the tree stresslet, with a 150-node shell and a
    60-node body (274 nodes: a depth-2 tree)."""
    _shell_and_body_step("tree", shell_n=150, body_n=60)


def test_two_body_buckets_of_equal_nodes_through_tree_match_jax():
    """Two body buckets of the same node total (a 60-node sphere with the
    bound fibers' sites and a 60-node sphere with none) through the tree
    stresslet (``ewald_min_sources = 0``): each bucket's sum keeps its own
    geometry (`PairEvaluator.at`), so the second is not served the
    first's, and the step matches the JAX package's (which builds the
    tree at every call) to 1e-10."""
    from skellysim_tpu_torch.bodies import bodies as tbd
    from skellysim_tpu_torch.periphery.precompute import precompute_body

    pre = precompute_body("sphere", 60, radius=0.5)
    second = tbd.make_group(
        pre["node_positions_ref"], pre["node_normals_ref"],
        pre["node_weights"], position=np.array([[0.0, 1.8, -0.5]]),
        external_force=np.array([[0.0, 0.0, -0.3]]), radius=np.array([0.5]),
        kind="sphere", config_rank=[1])
    plan = _shell_and_body_step("tree", shell_n=150, body_n=60,
                                extra_bodies=(second,))[0]
    assert plan.depth == 2


def test_kept_geometry_is_keyed_by_call_site():
    """Two node sets of one count summed through one tree `PairEvaluator`
    at two call sites (two body buckets' double layers onto the same
    targets): each sum is a fresh evaluator's bit for bit, none is NaN.
    Positions that move under one call site's kept key still come back
    NaN (the backstop)."""
    from skellysim_tpu_torch.ops import evaluator as tev
    from skellysim_tpu_torch.ops import treecode as ttc

    rng = np.random.default_rng(41)
    src = [torch.as_tensor(rng.uniform(-1, 1, (300, 3))) for _ in range(2)]
    trg = torch.as_tensor(rng.uniform(-1, 1, (800, 3)))
    f_dl = [torch.as_tensor(rng.standard_normal((300, 3, 3)))
            for _ in range(2)]
    plan = ttc.plan_tree(torch.cat(src + [trg]).numpy(), tol=1e-3)
    assert plan.depth >= 2
    pair = tev.make_pair(plan, "cpu")
    for _ in range(2):  # the second round is served the kept geometry
        for j in range(2):
            got = pair.at("body", j).stresslet(src[j], trg, f_dl[j], 1.0)
            fresh = tev.make_pair(plan, "cpu").stresslet(src[j], trg,
                                                         f_dl[j], 1.0)
            assert not torch.isnan(got).any()
            assert torch.equal(got, fresh)
    assert len(pair.geometry) == 2
    moved = pair.at("body", 0).stresslet(src[1], trg, f_dl[1], 1.0)
    assert torch.isnan(moved).all()


@functools.lru_cache(maxsize=None)
def _coupled_scene(shell_n, body_n):
    """The shell-and-body scene, built once for the module at each size
    (the tree tests share the 150 / 60 one; its tensors are only read)."""
    return ttesting.make_coupled_scene(shell_n=shell_n, body_n=body_n,
                                       n_bound=2, n_free=2)


def _shell_and_body_step(evaluator, shell_n=60, body_n=40, extra_bodies=()):
    from skellysim_tpu.bodies.bodies import BodyGroup as JBodies
    from skellysim_tpu.fibers.container import FiberGroup as JFibers
    from skellysim_tpu.periphery import periphery as jperi

    shell, shape, bodies, fibers = _coupled_scene(shell_n, body_n)
    params = JParams(**dict(_BASE, dt_initial=0.02, gmres_tol=1e-11,
                            ewald_tol=1e-4, ewald_min_sources=0,
                            pair_evaluator=evaluator, tree_tol=1e-3))
    jshape = jperi.PeripheryShape(kind=shape.kind, radius=shape.radius)
    jsys = JSystem(params, shell_shape=jshape)

    def jleaves(nt, cls):
        return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                      for k, v in nt._asdict().items()})

    jbodies = jleaves(bodies, JBodies)
    if extra_bodies:
        jbodies = (jbodies,) + tuple(jleaves(g, JBodies)
                                     for g in extra_bodies)
    jstate = jsys.make_state(fibers=jleaves(fibers, JFibers),
                             shell=jleaves(shell, jperi.PeripheryState),
                             bodies=jbodies)
    plan, tsys, tstate, _, _ = _step_both(jsys, jstate, jshape)
    if extra_bodies:
        return plan, tsys, tstate
    if evaluator == "tree":
        assert plan.depth == 2
    # the shell's flow really took the plan: it differs from the dense sum
    # by about the plan's tolerance, not by nothing
    pair = tsys._pair_args(tstate)
    r = tstate.fibers.x.reshape(-1, 3)
    d = torch.tensor(np.random.default_rng(3).standard_normal(3 * shell_n))
    fast = tsys._shell_flow(tstate, r, d, pair=pair)
    dense = tsys._shell_flow(tstate, r, d)
    rel = float((fast - dense).norm() / dense.norm())
    assert 0.0 < rel < 1e-2


def test_periodic_fibers_spectral_step_matches_jax():
    params = JParams(**dict(_BASE, pair_evaluator="spectral",
                            periodic_box=(4.0, 4.0, 4.0), spectral_tol=1e-6))
    jsys = JSystem(params)
    jstate = jsys.make_state(
        fibers=_fibers(n_fib=8, n_nodes=16, seed=3, lo=1.2, hi=2.8,
                       length=1.2),
        background=JBackground.make(uniform=(1.0, 0.0, 0.0)))
    plan = _step_both(jsys, jstate)[0]
    assert plan.mode == "tp"


@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_fibers_tree_step_matches_jax(precision):
    """20 arcs of 16 nodes (a depth-2 tree at tree_tol 1e-3) through
    "tree": the "full" f64 step and the "mixed" one (its f32 Krylov
    interior through the tree, its f64 prep flows and residual dense)
    land on the JAX package's fibers to 1e-10; "mixed" refines to
    gmres_tol."""
    params = JParams(**dict(_BASE, pair_evaluator="tree", tree_tol=1e-3,
                            solver_precision=precision, kernel_impl="pallas",
                            refine_pair_impl="exact"))
    jsys = JSystem(params)
    jstate = jsys.make_state(fibers=_fibers(n_fib=20, seed=11),
                             background=JBackground.make(uniform=(1., 0, 0)))
    tsys, tstate = _port(jsys, jstate)
    plan = _same_plan(jsys, jstate, tsys, tstate)
    assert plan.depth == 2
    assert tsys._precision_for(tstate) == precision
    jnew, jsol, jinfo = jsys.step(jstate)
    tnew, tsol, tinfo = tsys.step(tstate)
    assert tinfo.converged and bool(jinfo.converged)
    assert tinfo.residual_true <= 1e-10
    if precision == "mixed":
        assert tinfo.refines >= 1
    else:
        jsol = np.asarray(jsol)
        np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                                   atol=1e-10 * np.abs(jsol).max())
    np.testing.assert_allclose(tnew.fibers.x.numpy(),
                               np.asarray(jnew.fibers.x), rtol=0, atol=1e-10)


def test_mixed_ewald_step_refines_to_gmres_tol():
    """A coarse ewald_tol = 1e-4 Krylov interior in f32 still refines to
    gmres_tol = 1e-10: the f64 prep flows and residual stay dense. Both
    packages refine to it, so their solutions agree to 1e-8."""
    params = JParams(eta=1.0, dt_initial=1e-2, gmres_tol=1e-10,
                     adaptive_timestep_flag=False, solver_precision="mixed",
                     kernel_impl="pallas", refine_pair_impl="exact",
                     pair_evaluator="ewald", ewald_tol=1e-4)
    jsys = JSystem(params)
    jstate = jsys.make_state(fibers=_fibers(n_fib=12, seed=7),
                             background=JBackground.make(uniform=(1., 0, 0)))
    tsys, tstate = _port(jsys, jstate)
    assert tsys._precision_for(tstate) == "mixed"
    jnew, jsol, jinfo = jsys.step(jstate)
    tnew, tsol, tinfo = tsys.step(tstate)
    assert tinfo.converged and tinfo.refines >= 1
    assert tinfo.residual_true <= 1e-10
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-8 * np.abs(jsol).max())


def test_mixed_spectral_step_refines_on_the_periodic_operator():
    """Under "spectral" the mixed solver's f64 prep flows and refinement
    residual take the plan (no dense sum holds the periodic images): a
    mixed step reaches gmres_tol in a few sweeps and lands on the "full"
    step's solution, where the free-space solution lies far off."""
    sols = {}
    for ev, prec in (("spectral", "mixed"), ("spectral", "full"),
                     ("direct", "full")):
        over = dict(pair_evaluator=ev, solver_precision=prec,
                    kernel_impl="pallas", refine_pair_impl="exact")
        if ev == "spectral":
            over.update(periodic_box=(4.0, 4.0, 4.0), spectral_tol=1e-6)
        jsys = JSystem(JParams(**dict(_BASE, **over)))
        jstate = jsys.make_state(
            fibers=_fibers(n_fib=8, n_nodes=16, seed=3, lo=1.2, hi=2.8,
                           length=1.2),
            background=JBackground.make(uniform=(1.0, 0.0, 0.0)))
        tsys, tstate = _port(jsys, jstate)
        assert tsys._precision_for(tstate) == prec
        _, sol, info = tsys.step(tstate)
        assert info.converged and info.residual_true <= 1e-10
        if prec == "mixed":
            assert 1 <= info.refines <= 4
        sols[ev, prec] = sol.numpy()
    scale = np.abs(sols["spectral", "full"]).max()
    mixed_off = np.abs(sols["spectral", "mixed"]
                       - sols["spectral", "full"]).max()
    free_off = np.abs(sols["direct", "full"]
                      - sols["spectral", "full"]).max()
    # (the direct mixed and full steps of this scene differ by 3.9e-8 of
    # scale: the tension rows' conditioning at gmres_tol = 1e-10)
    assert mixed_off <= 1e-7 * scale
    assert free_off > 1e-4 * scale


def test_straight_fibers_leave_the_solve_uncoupled():
    """Straight fibers under their uniform tangential motor force in a
    uniform flow carry no implicit force at the solution: the "full" step
    takes one iteration and the periodic and free-space solutions agree to
    roundoff. Scenes that test the pair flows bend their fibers."""
    sols = {}
    for ev in ("spectral", "direct"):
        over = dict(pair_evaluator=ev, solver_precision="full")
        if ev == "spectral":
            over.update(periodic_box=(4.0, 4.0, 4.0), spectral_tol=1e-6)
        jsys = JSystem(JParams(**dict(_BASE, **over)))
        jstate = jsys.make_state(
            fibers=_fibers(n_fib=8, n_nodes=16, seed=3, lo=1.2, hi=2.8,
                           length=1.2, curvature=0.0),
            background=JBackground.make(uniform=(1.0, 0.0, 0.0)))
        tsys, tstate = _port(jsys, jstate)
        _, sol, info = tsys.step(tstate)
        assert info.converged and info.iters == 1
        sols[ev] = sol.numpy()
    np.testing.assert_allclose(sols["spectral"], sols["direct"], rtol=0,
                               atol=1e-12 * np.abs(sols["direct"]).max())


def test_cli_runs_fmm_config_like_jax(tmp_path):
    """A TOML that names the reference's "FMM" evaluator runs through the
    port's CLI (on the CPU) and the JAX package's to the same frames."""
    _cli_like_jax(tmp_path, "FMM", 6)


def test_cli_runs_tree_config_like_jax(tmp_path):
    """The same for ``pair_evaluator = "tree"`` (a depth-2 treecode at 20
    x 16 nodes)."""
    _cli_like_jax(tmp_path, "tree", 20)


def _cli_like_jax(tmp_path, evaluator, n_fib):
    from skellysim_tpu import cli as jcli
    from skellysim_tpu.io.trajectory import TrajectoryReader

    from skellysim_tpu_torch import cli as tcli
    from skellysim_tpu_torch.config import Config, Fiber

    rng = np.random.default_rng(100)
    cfg = Config()
    cfg.params.dt_initial = cfg.params.dt_max = cfg.params.dt_write = 0.01
    cfg.params.t_final = 0.02
    cfg.params.gmres_tol = 1e-11
    cfg.params.pair_evaluator = evaluator
    cfg.params.ewald_tol = 1e-7
    cfg.params.tree_tol = 1e-3
    for _ in range(n_fib):
        fib = Fiber(length=1.0, bending_rigidity=2.5e-3, force_scale=-0.05,
                    n_nodes=16)
        d = rng.normal(size=3)
        fib.fill_node_positions(rng.uniform(-2, 2, 3), d / np.linalg.norm(d))
        cfg.fibers.append(fib)
    frames = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        path = str(tmp_path / who / "skelly_config.toml")
        cfg.save(path)
        if who == "port":
            tcli.main([f"--config-file={path}", "--device=cpu",
                       "--log-level=WARNING"])
        else:
            jcli.run(path)
        reader = TrajectoryReader(str(tmp_path / who / "skelly_sim.out"))
        frames[who] = reader.load_frame(len(reader) - 1)
        assert len(reader) == 3
    a, b = frames["port"], frames["jax"]
    assert a["time"] == pytest.approx(b["time"], abs=1e-12)
    for ma, mb in zip(a["fibers"][1], b["fibers"][1]):
        np.testing.assert_allclose(ma["x_"], mb["x_"], rtol=0, atol=1e-8)
