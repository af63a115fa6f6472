"""The port's System, builder and CLI against the JAX package.

* the golden shear-motor run (tests/golden, written by the JAX package) at
  its own tolerances (x rtol 1e-8, tension 1e-6);
* one mixed-precision step (f32 Krylov interior on the "pallas" tier, f64
  refinement) from one state carried across with `convert`: both sides
  refine to gmres_tol = 1e-12, so the stepped positions agree to 1e-8;
* a TOML written by the port runs through ``python -m skellysim_tpu_torch
  --device=cpu`` and through `skellysim_tpu.cli.run`; the final frames,
  decoded by `skellysim_tpu.io.trajectory`, agree to 1e-8;
* unsupported features raise NotImplementedError naming the ROADMAP item.
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


@pytest.mark.parametrize("override,item", [
    (dict(pair_evaluator="ewald"), "10"),
    (dict(gmres_block_s=2), "3"),
    (dict(guard_dt_halvings=1), "13"),
    (dict(flight_window=4), "13"),
    (dict(refine_pair_impl="df"), "9"),
    (dict(kernel_impl="mxu"), "9"),
])
def test_unsupported_features_raise(override, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        System(Params(**override), device="cpu")


def test_unsupported_components_and_ring_fallback():
    system = System(Params(pair_evaluator="ring"), device="cpu")
    g = tfc.make_group(_fibers_x(nf=1), lengths=1.0, bending_rigidity=0.01,
                       radius=0.0125)
    with pytest.raises(NotImplementedError, match="item 5"):
        system.make_state(fibers=g, shell=object())
    with pytest.raises(NotImplementedError, match="item 6"):
        system.make_state(fibers=g, bodies=object())
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
