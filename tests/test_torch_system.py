"""The port's System, builder and CLI against the JAX package.

* the golden shear-motor run (tests/golden, written by the JAX package) at
  its own tolerances (x rtol 1e-8, tension 1e-6);
* one mixed-precision step (f32 Krylov interior on the "pallas" tier, f64
  refinement) from one state carried across with `convert`: both sides
  refine to gmres_tol = 1e-12, so the stepped positions agree to 1e-8;
* a TOML written by the port runs through ``python -m skellysim_tpu_torch
  --device=cpu`` and through `skellysim_tpu.cli.run`; the final frames,
  decoded by `skellysim_tpu.io.trajectory`, agree to 1e-8;
* confined and body-carrying steps (the clamped-shell scene in "gs" and
  "jacobi", a shell + body scene, fibers bound to a body, one mixed coupled
  step) against the JAX package's, and the walkthrough config through both
  packages' CLIs, with the port's own precompute;
* the same seed places the same fibers in both packages' schemas;
* the options that used to raise (s-step GMRES, the guard ladder, the
  flight recorder, the "df" refinement, the "mxu" tile) build and step.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.system import BackgroundFlow as JBackground
from skellysim_tpu.system import PointSources as JPoints
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.config import Config, Fiber
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.system import BackgroundFlow, System

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden",
                      "shear_motor_finalpositions.npz")


def _fibers_x(nf=4, n=16, seed=17):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    origins = rng.uniform(-1.0, 1.0, size=(nf, 3))
    dirs = rng.normal(size=(nf, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins[:, None, :] + t[None, :, None] * dirs[:, None, :]


def test_golden_shear_motor():
    """tests/test_golden_regression.py's scene, run by the port."""
    fibers = tfc.make_group(_fibers_x(), lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125, force_scale=-0.05,
                            dtype=torch.float64, device="cpu")
    params = Params(eta=1.0, dt_initial=0.005, t_final=0.05, gmres_tol=1e-12,
                    adaptive_timestep_flag=False)
    system = System(params, device="cpu")
    state = system.make_state(
        fibers=fibers,
        background=BackgroundFlow.make(components=(1, 0, 2),
                                       scale=(0.5, 0.0, 0.0)))
    final = system.run(state)
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(final.fibers.x.numpy(), z["x"],
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(final.fibers.tension.numpy(),
                                   z["tension"], rtol=1e-6, atol=1e-6)


def test_mixed_step_matches_jax():
    params = dict(eta=1.0, dt_initial=0.01, t_final=1.0, gmres_tol=1e-12,
                  solver_precision="mixed", kernel_impl="pallas",
                  adaptive_timestep_flag=False)
    jsys = JSystem(JParams(**params, refine_pair_impl="exact"))
    g = jfc.make_group(_fibers_x(seed=5), lengths=1.0, bending_rigidity=0.01,
                       radius=0.0125, force_scale=-0.05, dtype=jnp.float64)
    pts = JPoints.make(position=[[0.3, 0.2, 0.1]], force=[[0.0, 0.0, 1.0]],
                       torque=[[0.2, 0.0, 0.0]])
    bg = JBackground.make(uniform=(0.1, 0.0, 0.0), components=(1, 0, 2),
                          scale=(0.5, 0.0, 0.0))
    jstate = jsys.make_state(fibers=g, points=pts, background=bg)
    jnew, _, jinfo = jsys.step(jstate)

    tparams = convert.params_from_dict(dataclasses.asdict(jsys.params))
    tsys = System(tparams, device="cpu")
    assert tsys._precision_for(
        convert.state_from_numpy(
            {k: np.asarray(v) for k, v in g._asdict().items()
             if v is not None}, time=0.0, dt=0.01, device="cpu")) == "mixed"
    tstate = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items() if v is not None},
        time=float(jstate.time), dt=float(jstate.dt),
        points={k: np.asarray(v) for k, v in pts._asdict().items()},
        background={k: np.asarray(v) for k, v in bg._asdict().items()},
        device="cpu")
    tnew, sol, tinfo = tsys.step(tstate)
    assert tinfo.converged and bool(jinfo.converged)
    assert tinfo.residual_true <= 1e-12
    assert tinfo.refines >= 1
    np.testing.assert_allclose(tnew.fibers.x.numpy(), np.asarray(jnew.fibers.x),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tnew.fibers.tension.numpy(),
                               np.asarray(jnew.fibers.tension), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(
                                   jnew.fibers.tension)).max())


def _write_small_config(path, nf=8, n=16):
    rng = np.random.default_rng(100)
    cfg = Config()
    cfg.params.dt_initial = 0.01
    cfg.params.dt_max = 0.01
    cfg.params.dt_write = 0.01
    cfg.params.t_final = 0.03
    cfg.params.gmres_tol = 1e-12
    cfg.background.scale_factor = [0.5, 0.0, 0.0]
    cfg.background.components = [1, 0, 2]
    for _ in range(nf):
        fib = Fiber(length=1.0, bending_rigidity=2.5e-3, force_scale=-0.05,
                    n_nodes=n)
        d = rng.normal(size=3)
        fib.fill_node_positions(rng.uniform(-2, 2, 3), d / np.linalg.norm(d))
        cfg.fibers.append(fib)
    cfg.save(path)


def test_cli_port_toml_runs_in_both(tmp_path):
    from skellysim_tpu import cli as jcli
    from skellysim_tpu.io.trajectory import TrajectoryReader

    from skellysim_tpu_torch.io.trajectory import TrajectoryReader as TReader

    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    pdir.mkdir()
    jdir.mkdir()
    _write_small_config(str(pdir / "skelly_config.toml"))
    (jdir / "skelly_config.toml").write_bytes(
        (pdir / "skelly_config.toml").read_bytes())

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "skellysim_tpu_torch", "--device=cpu",
         "--config-file=skelly_config.toml", "--metrics-file=metrics.jsonl"],
        cwd=pdir, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jcli.run(str(jdir / "skelly_config.toml"))

    tr = TrajectoryReader(str(pdir / "skelly_sim.out"))
    jr = TrajectoryReader(str(jdir / "skelly_sim.out"))
    assert len(tr) == len(jr) == 4  # initial + one frame per step
    for i in (0, len(jr) - 1):
        a, b = tr.load_frame(i), jr.load_frame(i)
        assert a["time"] == pytest.approx(b["time"], abs=1e-12)
        assert a["rng_state"] == b["rng_state"]
        fa, fb = a["fibers"][1], b["fibers"][1]
        assert len(fa) == len(fb) == 8
        for ma, mb in zip(fa, fb):
            np.testing.assert_allclose(ma["x_"], mb["x_"], rtol=0, atol=1e-8)
            np.testing.assert_allclose(ma["tension_"], mb["tension_"],
                                       rtol=0, atol=1e-8 * max(
                                           1.0, np.abs(mb["tension_"]).max()))
    # the port reads its own frames with its own msgpack decoder
    own = TReader(str(pdir / "skelly_sim.out"))
    np.testing.assert_array_equal(own.load_frame(len(own) - 1)["fibers"][1][0]["x_"],
                                  tr.load_frame(len(tr) - 1)["fibers"][1][0]["x_"])
    lines = (pdir / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3


def test_toml_round_trips_between_packages(tmp_path):
    """A TOML written by the JAX schema builds in the port, and one written
    by the port builds in the JAX package, with the same fibers."""
    from skellysim_tpu import builder as jbuilder
    from skellysim_tpu.config import Config as JConfig, Fiber as JFiber

    from skellysim_tpu_torch import builder as tbuilder

    port_toml = str(tmp_path / "port.toml")
    _write_small_config(port_toml, nf=3)
    jsys, jstate, _ = jbuilder.build_simulation(port_toml)
    tsys, tstate, _ = tbuilder.build_simulation(port_toml, device="cpu")
    np.testing.assert_array_equal(tstate.fibers.x.numpy(),
                                  np.asarray(jstate.fibers.x))
    assert tsys.params.gmres_tol == jsys.params.gmres_tol

    jcfg = JConfig()
    f = JFiber(n_nodes=16, force_scale=0.1)
    f.fill_node_positions([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    jcfg.fibers = [f]
    jcfg.params.kernel_impl = "pallas"
    jax_toml = str(tmp_path / "jax.toml")
    jcfg.save(jax_toml)
    tsys, tstate, rng = tbuilder.build_simulation(jax_toml, device="cpu")
    assert tsys.params.kernel_impl == "pallas"
    assert tstate.fibers.force_scale.tolist() == [0.1]
    assert rng.dump_state()[0][1] == f"{jcfg.params.seed}:0:0"


def _leaves(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


def _port_step(jsys, jstate, shape=None):
    """One port step from the JAX system's params and state; returns
    (new_state, solution, info)."""
    from skellysim_tpu_torch.periphery import periphery as tperi

    tsys = System(convert.params_from_dict(dataclasses.asdict(jsys.params)),
                  shell_shape=(None if shape is None else tperi.PeripheryShape(
                      **dataclasses.asdict(shape))), device="cpu")
    bodies = jstate.bodies
    tstate = convert.state_from_numpy(
        None if jstate.fibers is None else _leaves(jstate.fibers),
        time=float(jstate.time), dt=float(jstate.dt),
        shell=None if jstate.shell is None else _leaves(jstate.shell),
        bodies=None if bodies is None else _leaves(bodies), device="cpu")
    return tsys.step(tstate)


def _assert_same_step(jout, tout, tol):
    """Solutions agree to ``tol`` of their largest entry, and so do the
    stepped fibers, shell density and body placement."""
    (jn, jsol, ji), (tn, tsol, ti) = jout, tout
    assert ti.converged and bool(ji.converged)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=tol * np.abs(jsol).max())
    if jn.fibers is not None:
        np.testing.assert_allclose(tn.fibers.x.numpy(), np.asarray(jn.fibers.x),
                                   rtol=0, atol=tol)
    if jn.bodies is not None:
        for k in ("position", "orientation"):
            np.testing.assert_allclose(getattr(tn.bodies, k).numpy(),
                                       np.asarray(getattr(jn.bodies, k)),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("precond", ["gs", "jacobi"])
def test_clamped_shell_step_matches_jax(precond):
    """tests/test_precond.py's clamped-shell scene (96-node sphere shell, 6
    clamped fibers x 24 nodes) in "full": the port takes as many GMRES
    iterations as the JAX package and its solution agrees to 1e-10 (both
    solve to gmres_tol = 1e-10; the same arithmetic differs only in
    summation order)."""
    from test_precond import BASE, _clamped_shell_scene

    jsys, jstate = _clamped_shell_scene(dataclasses.replace(BASE,
                                                            precond=precond))
    jout = jsys.step(jstate)
    tout = _port_step(jsys, jstate, jsys.shell_shape)
    _assert_same_step(jout, tout, 1e-10)
    assert tout[2].iters == int(jout[2].iters)


def test_plus_pinning_step_matches_jax():
    """With `periphery_binding` active, plus ends inside the polar window
    and within the threshold of the wall hinge (`_update_plus_pinning`);
    the port pins the same fibers as JAX and its step (pinned BC rows and
    their matvec coupling) agrees to 1e-10."""
    from skellysim_tpu.params import PeripheryBinding
    from skellysim_tpu.periphery import periphery as jperi
    from skellysim_tpu.periphery import shapes as jshapes

    radius, shell_n = 3.0, 96
    spec = jshapes.sphere_shape(shell_n, radius=radius)
    normals = -spec.node_normals
    weights = np.full(shell_n, 4 * np.pi * radius**2 / shell_n)
    op, M_inv = jperi.build_shell_operator(spec.nodes, normals, weights)
    shell = jperi.make_state(spec.nodes, normals, weights, op, M_inv)
    shape = jperi.PeripheryShape(kind="sphere", radius=radius)
    d = np.array([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8], [0.0, 0.0, -1.0],
                  [1.0, 0.0, 0.0]])
    start = np.array([1.6, 1.6, 1.6, 0.5])
    t = np.linspace(0, 1, 16)
    x = (start[:, None, None] + t[None, :, None]) * d[:, None, :]
    fibers = jfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125, force_scale=-0.05)
    params = JParams(eta=1.0, dt_initial=0.01, gmres_tol=1e-11,
                     adaptive_timestep_flag=False,
                     periphery_binding=PeripheryBinding(
                         active=True, polar_angle_start=0.0,
                         polar_angle_end=0.5 * np.pi, threshold=0.75))
    jsys = JSystem(params, shell_shape=shape)
    jstate = jsys.make_state(fibers=fibers, shell=shell)
    pinned = np.asarray(jsys._update_plus_pinning(jstate).fibers.plus_pinned)
    # tips at |p| = 2.6 in the window (z up, tilted) pin; the one pointing
    # down and the short one do not
    assert pinned.tolist() == [True, True, False, False]
    jout = jsys.step(jstate)
    tout = _port_step(jsys, jstate, shape)
    np.testing.assert_array_equal(tout[0].fibers.plus_pinned.numpy(), pinned)
    _assert_same_step(jout, tout, 1e-10)


def test_shell_and_body_step_matches_jax():
    """A shell + body scene from `skellysim_tpu.testing.make_coupled_parts`
    (the port's `testing.make_coupled_parts` builds the same arrays), with
    a free fiber: solution, fiber and body placement agree to 1e-10."""
    from skellysim_tpu.testing import make_coupled_parts

    from skellysim_tpu_torch import testing as ttesting

    shell, shape, bodies = make_coupled_parts(120, 80, jnp.float64)
    tshell, _, tbodies = ttesting.make_coupled_parts(120, 80)
    np.testing.assert_allclose(tshell.stresslet_plus_complementary.numpy(),
                               np.asarray(shell.stresslet_plus_complementary),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tbodies.nodes_ref.numpy(),
                                  np.asarray(bodies.nodes_ref))
    t = np.linspace(0, 1, 16)
    x = np.array([0.0, 2.5, 0.0]) + t[:, None] * np.array([0.0, 0.0, 1.0])
    fibers = jfc.make_group(x[None], lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125, dtype=jnp.float64)
    jsys = JSystem(JParams(eta=1.0, dt_initial=0.05, gmres_tol=1e-11,
                           adaptive_timestep_flag=False), shell_shape=shape)
    jstate = jsys.make_state(fibers=fibers, shell=shell, bodies=bodies)
    _assert_same_step(jsys.step(jstate), _port_step(jsys, jstate, shape),
                      1e-10)


def test_fiber_bound_to_body_matches_jax():
    """tests/test_bodies.py's fiber-body link scene run for three steps in
    both packages: positions agree to 1e-10 and the fiber stays pinned to
    its (moving) nucleation site to 1e-12."""
    from skellysim_tpu.bodies import bodies as jbd
    from skellysim_tpu.periphery.precompute import precompute_body

    from skellysim_tpu_torch.bodies import bodies as tbd

    pre = precompute_body("sphere", 400, radius=0.5)
    group = jbd.make_group(pre["node_positions_ref"], pre["node_normals_ref"],
                           pre["node_weights"], radius=0.5, kind="sphere",
                           external_force=[0.0, 0.0, 1.0],
                           nucleation_sites_ref=[[0.0, 0.0, 0.5]])
    t = np.linspace(0, 1, 16)
    x = np.stack([np.zeros(16), np.zeros(16), 0.5 + 0.6 * t], axis=1)[None]
    fibers = jfc.make_group(x, lengths=0.6, bending_rigidity=0.01,
                            radius=0.0125, binding_body=0, binding_site=0)
    params = JParams(eta=1.0, dt_initial=0.01, t_final=0.03, gmres_tol=1e-9,
                     adaptive_timestep_flag=False)
    jsys = JSystem(params)
    jstate = jsys.make_state(fibers=fibers, bodies=group)
    jfinal = jsys.run(jstate)
    tsys = System(convert.params_from_dict(dataclasses.asdict(params)),
                  device="cpu")
    tstate = convert.state_from_numpy(_leaves(fibers), time=0.0,
                                      dt=float(jstate.dt),
                                      bodies=_leaves(group), device="cpu")
    tfinal = tsys.run(tstate)
    np.testing.assert_allclose(tfinal.fibers.x.numpy(),
                               np.asarray(jfinal.fibers.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tfinal.bodies.position.numpy(),
                               np.asarray(jfinal.bodies.position), rtol=0,
                               atol=1e-10)
    sites = tbd.place(tfinal.bodies)[2]
    assert float((tfinal.fibers.x[0, 0] - sites[0, 0]).norm()) < 1e-12
    assert float(tfinal.bodies.position[0, 2]) > 1e-3


def test_mixed_coupled_step_matches_jax():
    """One mixed-precision step (f32 Krylov interior on the "pallas" tier,
    f32 shell inverse and body LU, f64 refinement; JAX's refinement tile
    "exact") of the port's small coupled scene — shell, body with bound
    fibers, free fibers — in both packages: both refine to
    gmres_tol = 1e-12, so the solutions agree to 1e-8."""
    from skellysim_tpu.bodies.bodies import BodyGroup as JBodies
    from skellysim_tpu.fibers.container import FiberGroup as JFibers
    from skellysim_tpu.periphery import periphery as jperi

    from skellysim_tpu_torch import testing as ttesting

    shell, shape, bodies, fibers = ttesting.make_coupled_scene(
        shell_n=120, body_n=80, n_bound=4, n_free=2)
    params = JParams(eta=1.0, dt_initial=0.02, gmres_tol=1e-12,
                     adaptive_timestep_flag=False, solver_precision="mixed",
                     kernel_impl="pallas", refine_pair_impl="exact")
    jshape = jperi.PeripheryShape(kind=shape.kind, radius=shape.radius)
    jsys = JSystem(params, shell_shape=jshape)

    def jleaves(nt, cls):
        return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                      for k, v in nt._asdict().items()})

    jshell = jleaves(shell, jperi.PeripheryState)
    jstate = jsys.make_state(
        fibers=jleaves(fibers, JFibers), bodies=jleaves(bodies, JBodies),
        shell=jshell._replace(M_inv=jshell.M_inv.astype(jnp.float32)))
    jout = jsys.step(jstate)
    tout = _port_step(jsys, jstate, jshape)
    assert tout[2].refines >= 1 and tout[2].residual_true <= 1e-12
    _assert_same_step(jout, tout, 1e-8)


def _walkthrough_config(path):
    """docs/getting_started.md's walkthrough config, with the port's
    schema."""
    from skellysim_tpu_torch.config import Body, ConfigSpherical

    config = ConfigSpherical()
    config.params.eta = 1.0
    config.params.dt_initial = 0.1
    config.params.dt_write = 0.1
    config.params.t_final = 0.4
    config.params.adaptive_timestep_flag = False
    config.periphery.n_nodes = 100
    config.periphery.radius = 4.16
    config.bodies = [Body(position=[0.0, 0.0, 0.0], shape="sphere",
                          radius=0.5, n_nodes=100,
                          external_force=[0.0, 0.0, 0.5])]
    fib = Fiber(n_nodes=16, length=1.0, bending_rigidity=0.0025)
    fib.fill_node_positions(np.array([0.0, 1.5, 0.0]),
                            np.array([0.0, 0.0, 1.0]))
    config.fibers = [fib]
    config.save(path)


def test_walkthrough_cli_runs_in_both(tmp_path):
    """The walkthrough config, written by the port's schema and
    precomputed by ``python -m skellysim_tpu_torch.precompute``, runs
    through ``python -m skellysim_tpu_torch --device=cpu`` and through
    `skellysim_tpu.cli.run`; the final frames, decoded by
    `skellysim_tpu.io.trajectory`, agree to 1e-8 (shell density scaled by
    its largest entry), and the port's reader decodes its own frames."""
    from skellysim_tpu import cli as jcli
    from skellysim_tpu.io.trajectory import TrajectoryReader

    from skellysim_tpu_torch.io.trajectory import TrajectoryReader as TReader

    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    pdir.mkdir()
    jdir.mkdir()
    _walkthrough_config(str(pdir / "skelly_config.toml"))
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd in (["-m", "skellysim_tpu_torch.precompute", "--device=cpu",
                 "skelly_config.toml"],
                ["-m", "skellysim_tpu_torch", "--device=cpu",
                 "--config-file=skelly_config.toml"]):
        proc = subprocess.run([sys.executable, *cmd], cwd=pdir, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("skelly_config.toml", "periphery_precompute.npz",
                 "body_precompute.npz"):
        (jdir / name).write_bytes((pdir / name).read_bytes())
    jcli.run(str(jdir / "skelly_config.toml"))

    tr = TrajectoryReader(str(pdir / "skelly_sim.out"))
    jr = TrajectoryReader(str(jdir / "skelly_sim.out"))
    assert len(tr) == len(jr) == 5
    a, b = tr.load_frame(len(tr) - 1), jr.load_frame(len(jr) - 1)
    assert a["time"] == pytest.approx(b["time"], abs=1e-12)
    da = np.asarray(a["shell"]["solution_vec_"])
    db = np.asarray(b["shell"]["solution_vec_"])
    assert da.shape == db.shape == (300,)
    np.testing.assert_allclose(da, db, rtol=0, atol=1e-8 * np.abs(db).max())
    ba, bb = a["bodies"][0][0], b["bodies"][0][0]
    for k in ("position_", "orientation_", "solution_vec_"):
        np.testing.assert_allclose(np.asarray(ba[k]), np.asarray(bb[k]),
                                   rtol=0, atol=1e-8)
    np.testing.assert_allclose(a["fibers"][1][0]["x_"],
                               b["fibers"][1][0]["x_"], rtol=0, atol=1e-8)
    own = TReader(str(pdir / "skelly_sim.out")).load_frame(len(tr) - 1)
    np.testing.assert_array_equal(own["shell"]["solution_vec_"], da)
    np.testing.assert_array_equal(own["bodies"][0][0]["orientation_"],
                                  np.asarray(ba["orientation_"]))


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid", "revolution",
                                  "body"])
def test_move_fibers_to_surface_same_seed_same_fibers(kind):
    """With the same numpy seed the port's placement helpers put every
    fiber (and body nucleation site) exactly where the JAX package's do."""
    from skellysim_tpu.config import schema as jschema

    from skellysim_tpu_torch.config import schema as tschema

    def place(mod):
        rng = np.random.default_rng(100)
        fibers = [mod.Fiber(n_nodes=16, minus_clamped=True)
                  for _ in range(12)]
        if kind == "sphere":
            mod.SphericalPeriphery(radius=3.0).move_fibers_to_surface(
                fibers, ds_min=0.1, rng=rng, verbose=False)
        elif kind == "ellipsoid":
            mod.EllipsoidalPeriphery().move_fibers_to_surface(
                fibers, ds_min=0.1, rng=rng, verbose=False)
        elif kind == "revolution":
            env = {"height": "0.5 * T * ((1 + 2*x/length)**p1) * "
                             "((1 - 2*x/length)**p2) * length",
                   "T": 0.72, "p1": 0.4, "p2": 0.2, "length": 4.0,
                   "lower_bound": -2.0, "upper_bound": 2.0,
                   "n_nodes_target": 200}
            mod.RevolutionPeriphery(envelope=env).move_fibers_to_surface(
                fibers, ds_min=0.1, rng=rng, verbose=False)
        else:
            body = mod.Body(n_nucleation_sites=6, radius=0.5)
            body.generate_nucleation_sites(0.1, verbose=False, rng=rng)
            body.move_fibers_to_surface(fibers, ds_min=0.1, rng=rng,
                                        verbose=False)
            return [f.x for f in fibers] + [body.nucleation_sites]
        return [f.x for f in fibers]

    assert place(tschema) == place(jschema)


@pytest.mark.parametrize("override,item", [
    (dict(gmres_block_s=2), "3"),
    (dict(guard_dt_halvings=1), "13"),
    (dict(flight_window=4), "13"),
    (dict(refine_pair_impl="df"), "9"),
    (dict(kernel_impl="mxu"), "9"),
])
def test_unsupported_features_raise(override, item):
    """The options of items 3, 9 and 13 that the port now carries (s-step
    GMRES, the guard ladder, the flight recorder, the double-float
    refinement, the mxu tile) build and step a small fiber scene to a
    converged, healthy answer; none raises any more (the armed recorder
    wrote its row, tests/test_torch_flight.py holds it to the JAX
    package's)."""
    system = System(Params(dt_initial=0.01, gmres_tol=1e-10,
                           adaptive_timestep_flag=False, **override),
                    device="cpu")
    g = tfc.make_group(_fibers_x(), lengths=1.0, bending_rigidity=0.01,
                       radius=0.0125, force_scale=-0.05)
    state = system.make_state(fibers=g, background=BackgroundFlow.make(
        uniform=(1.0, 0.0, 0.0), dtype=torch.float64, device="cpu"))
    new, _, info = system.step(state)
    assert info.converged and info.health == 0 and info.guard_retries == 0
    assert bool(torch.isfinite(new.fibers.x).all())
    if "flight_window" in override:
        assert int(new.flight.count) == 1


def test_unsupported_components_and_ring_fallback(tmp_path):
    """A shell needs the System's shell shape; a deformable body (a stub in
    the reference) raises naming the reference's stub, as the JAX package
    does; "ring" on one card warns and runs direct."""
    from skellysim_tpu_torch import builder as tbuilder
    from skellysim_tpu_torch.config import Body, Config

    system = System(Params(pair_evaluator="ring"), device="cpu")
    g = tfc.make_group(_fibers_x(nf=1), lengths=1.0, bending_rigidity=0.01,
                       radius=0.0125)
    with pytest.raises(ValueError, match="shell_shape"):
        system.make_state(fibers=g, shell=object())
    cfg = Config(bodies=[Body(shape="deformable")])
    with pytest.raises(NotImplementedError,
                       match="declared but not implemented"):
        tbuilder.build_bodies(cfg.bodies, str(tmp_path), torch.float64, "cpu")
    state = system.make_state(fibers=g)
    with pytest.warns(UserWarning, match="falls back to 'direct'"):
        system.step(state)


def test_card_is_the_default_and_never_silently_cpu():
    """With no card, the default device raises instead of running on the
    CPU; with a card the default is the card."""
    if torch.cuda.is_available():
        assert System(Params()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            System(Params())
