"""The port's velocity field, line integrators, listener and client against
the JAX package's, on the CPU in float64.

* `System.velocity_at_targets` at points around and inside the coupled
  scene (shell, fibers, a sphere body) and inside an ellipsoid body, to
  1e-12 of the largest velocity, and through "ewald" / "tree" with the
  plan over the nodes and the points equal to JAX's, to 1e-10. The field
  is a function of (state, solution); on the coupled scene it is held at
  1e-12 on a random solution vector. On the solve's own solution the
  fiber force densities are the stiff fiber operator (rows up to ~1e7)
  applied to smooth positions, which cancel to ~1e-10 of the operator's
  scale, so there the two packages' matmul orders leave ~1e-11 of the
  field: that case checks the rigid motion inside the body, bit for bit;
* `streamlines` / `vortex_lines` on JAX's analytic fields (uniform flow,
  rigid rotation, the singularity bailout): equal sample counts, 1e-12;
* `process_request` on the listener example's scene (a short run written
  by the port's CLI) against JAX's on the same trajectory: equal counts,
  lines within 1e-9; the evaluator switch, an invalid frame and an
  unknown evaluator through `serve`;
* the framing both ways between the two packages' `protocol`, and one
  `Listener` subprocess round trip with ``--device=cpu``.
"""

import io as _io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu import listener as jlistener
from skellysim_tpu.audit import fixtures
from skellysim_tpu.postprocess import streamlines as jstreamlines
from skellysim_tpu.postprocess import vortex_lines as jvortex_lines
from skellysim_tpu.serve import protocol as jprotocol
from skellysim_tpu_torch import listener as tlistener
from skellysim_tpu_torch.postprocess import streamlines, vortex_lines
from skellysim_tpu_torch.serve import protocol
from skellysim_tpu_torch.system.system import solution_from_state
from torch_jax_state import port_state, port_system

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _solved(jsys, jstate):
    """(port system, port solved state, port solution, JAX solved state,
    JAX solution) after one JAX step."""
    jnew, jsol, jinfo = jsys.step(jstate)
    assert bool(jinfo.converged)
    return (port_system(jsys), port_state(jnew),
            torch.as_tensor(np.array(jsol)), jnew, jsol)


def _close(t, j, rel):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rel * np.abs(j).max())


def test_velocity_at_targets_matches_jax_inside_and_around_bodies():
    js = fixtures.make_system(shell=True)
    tsys, tst, tsol, jst, jsol = _solved(js, fixtures.coupled_state(js))
    rng = np.random.default_rng(3)
    center = np.asarray(jst.bodies.position)[0]
    pts = np.concatenate([rng.uniform(-4, 4, (40, 3)),
                          center + rng.uniform(-0.3, 0.3, (6, 3))])
    x = rng.standard_normal(tsol.shape)
    _close(tsys.velocity_at_targets(tst, torch.as_tensor(x), pts),
           js.velocity_at_targets(jst, jnp.asarray(x), pts), 1e-12)
    tv = tsys.velocity_at_targets(tst, tsol, pts)
    # the probes inside the sphere body move with it
    vel6 = tst.bodies.solution[0, -6:]
    dx = torch.as_tensor(pts[40:] - center)
    rigid = vel6[:3] + torch.cross(vel6[3:].expand_as(dx), dx, dim=-1)
    assert torch.equal(tv[40:], rigid)
    # the solution rebuilt from the state is the solve's
    assert torch.equal(solution_from_state(tst), tsol)


def test_velocity_inside_an_ellipsoid_body_matches_jax():
    from skellysim_tpu.bodies import bodies as jbd
    from skellysim_tpu.params import Params
    from skellysim_tpu.periphery.precompute import precompute_body
    from skellysim_tpu.system import System as JSystem

    a, b, c = 0.8, 0.4, 0.4
    pre = precompute_body("ellipsoid", 200, a=a, b=b, c=c)
    group = jbd.make_group(pre["node_positions_ref"], pre["node_normals_ref"],
                           pre["node_weights"], kind="ellipsoid",
                           semiaxes=[a, b, c], external_force=[0.0, 0.0, 1.0])
    js = JSystem(Params(eta=1.0, dt_initial=0.05, t_final=0.05,
                        gmres_tol=1e-10, adaptive_timestep_flag=False))
    tsys, tst, tsol, jst, jsol = _solved(js, js.make_state(bodies=group))
    # inside along the long axis (outside the inscribed sphere), inside,
    # and just outside
    pts = np.array([[0.6, 0.0, 0.0], [0.0, 0.2, 0.1], [1.2, 0.0, 0.0],
                    [0.0, 0.0, 0.45]])
    _close(tsys.velocity_at_targets(tst, tsol, pts),
           js.velocity_at_targets(jst, jsol, pts), 1e-12)


@pytest.mark.parametrize("evaluator", ["ewald", "tree"])
def test_velocity_through_fast_plans_matches_jax(evaluator):
    """The plan over the nodes and the probes equals JAX's field for field
    (`_plan_points`' ``extra_targets``), and the field through it agrees
    to 1e-10; probes far outside the nodes' box stay inside the plan."""
    from skellysim_tpu.params import Params
    from skellysim_tpu.system import BackgroundFlow as JBackground
    from skellysim_tpu.system import System as JSystem
    from test_torch_fast_system import _fibers

    js = JSystem(Params(eta=1.0, dt_initial=1e-3, gmres_tol=1e-10,
                        adaptive_timestep_flag=False,
                        pair_evaluator=evaluator, ewald_tol=1e-7,
                        tree_tol=1e-3, kernel_impl="pallas",
                        solver_precision="full"))
    jstate = js.make_state(fibers=_fibers(n_fib=20, seed=11),
                           background=JBackground.make(uniform=(1., 0, 0)))
    tsys, tst, tsol, jst, jsol = _solved(js, jstate)
    pts = np.random.default_rng(5).uniform(-4, 4, (50, 3))
    make = {"ewald": "make_ewald_plan", "tree": "make_tree_plan"}[evaluator]
    jp = getattr(js, make)(jst, extra_targets=pts)
    tp = getattr(tsys, make)(tst, extra_targets=torch.as_tensor(pts))
    assert tp.__dict__ == jp.__dict__
    if evaluator == "tree":
        assert tp.depth >= 2
    _close(tsys.velocity_at_targets(tst, tsol, pts),
           js.velocity_at_targets(jst, jsol, pts), 1e-10)


# ----------------------------------------------------------- the integrator

def _uniform(u):
    return (lambda x: jnp.broadcast_to(jnp.asarray(u), x.shape),
            lambda x: torch.as_tensor(u).expand(x.shape))


def _rotation(omega):
    def jv(x):
        return jnp.cross(jnp.broadcast_to(jnp.asarray(omega), x.shape), x)

    def tv(x):
        return torch.cross(torch.as_tensor(omega).expand(x.shape), x, dim=-1)
    return jv, tv


def _ramp(x):
    return 200.0 * x


def _same_lines(tl, jl, tol=1e-12):
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a["x"].shape == b["x"].shape, (a["x"].shape, b["x"].shape)
        for k in ("x", "val", "time"):
            ref = np.asarray(b[k])
            np.testing.assert_allclose(a[k], ref, rtol=0,
                                       atol=tol * max(np.abs(ref).max(), 1))


@pytest.mark.parametrize("case", ["uniform", "rotation", "bailout",
                                  "vortex"])
def test_lines_on_analytic_fields_match_jax(case):
    if case == "uniform":
        jv, tv = _uniform(np.array([0.3, -0.2, 0.1]))
        x0, kw = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]), {}
    elif case == "rotation":
        jv, tv = _rotation(np.array([0.0, 0.0, 1.0]))
        x0 = np.array([[1.0, 0.0, 0.5], [0.3, 0.2, 0.0]])
        kw = dict(dt_init=0.05, t_final=2.0, rel_err=1e-10, abs_err=1e-12)
    elif case == "bailout":
        jv = tv = _ramp
        x0 = np.array([[1.0, 1.0, 1.0]])
        kw = dict(dt_init=1e-3, t_final=5.0, back_integrate=False)
    else:
        jv, tv = _rotation(np.array([0.0, 0.0, 0.5]))
        x0 = np.array([[0.2, 0.1, 0.0], [1.0, -1.0, 0.5]])
        kw = dict(dt_init=0.1, t_final=1.0)
    integrate = (vortex_lines, jvortex_lines) if case == "vortex" else (
        streamlines, jstreamlines)
    tl = integrate[0](tv, x0, **kw)
    # op by op: XLA's fused loop body contracts products and sums into
    # FMAs, which the error estimate (a difference of two near-equal
    # stage sums) turns into other step sizes
    with jax.disable_jit():
        jl = integrate[1](jv, x0, **kw)
    _same_lines(tl, jl)
    if case == "bailout":
        assert tl[0]["time"][-1] < 5.0
    if case == "vortex":
        np.testing.assert_allclose(tl[0]["val"], [[0.0, 0.0, 1.0]]
                                   * len(tl[0]["time"]), atol=1e-6)


# -------------------------------------------------------------- the listener

@pytest.fixture(scope="module")
def listener_run(tmp_path_factory):
    """The listener example's scene (examples/listener_mode/gen_config.py,
    cut to 4 steps of dt 0.01) run by the port's CLI on the CPU."""
    from skellysim_tpu.config import BackgroundSource, Config, Fiber
    from skellysim_tpu_torch import cli

    d = tmp_path_factory.mktemp("listener")
    config = Config()
    config.params.dt_initial = 0.01
    config.params.dt_write = 0.02
    config.params.t_final = 0.04
    config.params.adaptive_timestep_flag = False
    fib = Fiber(length=1.0, bending_rigidity=1e-2, n_nodes=32)
    fib.fill_node_positions(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    config.fibers = [fib]
    config.background = BackgroundSource(uniform=[0.5, 0.0, 0.0])
    path = str(d / "skelly_config.toml")
    config.save(path)
    cli.run(path, device="cpu")
    return path, str(d / "skelly_sim.out")


def _request(frame_no=1, evaluator="CPU"):
    return {
        "frame_no": frame_no, "evaluator": evaluator,
        "streamlines": {"dt_init": 0.05, "t_final": 0.3, "abs_err": 1e-8,
                        "rel_err": 1e-6, "back_integrate": True,
                        "x0": np.array([[0.3, 0.1, 0.5], [-0.4, 0.2, 0.8],
                                        [2.0, 0.0, 0.5]])},
        "vortexlines": {"dt_init": 0.05, "t_final": 0.2,
                        "back_integrate": False,
                        "x0": np.array([[0.2, 0.0, 0.4]])},
        "velocity_field": {"x": np.array([[0.1, 0.1, 0.1], [5.0, 0.0, 0.0],
                                          [0.0, 0.05, 0.9]])},
    }


def _both(listener_run, cmd):
    from skellysim_tpu import builder as jbuilder
    from skellysim_tpu.io.trajectory import TrajectoryReader as JReader
    from skellysim_tpu_torch import builder as tbuilder
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    path, traj = listener_run
    jsys, jtemplate, _ = jbuilder.build_simulation(path)
    tsys, ttemplate, _ = tbuilder.build_simulation(path, device="cpu")
    jsys, _ = jlistener.switch_evaluator(jsys, cmd.get("evaluator"))
    tsys, _ = tlistener.switch_evaluator(tsys, cmd.get("evaluator"))
    jres = jlistener.process_request(jsys, jtemplate, JReader(traj), cmd)
    stats = {}
    tres = tlistener.process_request(tsys, ttemplate, TrajectoryReader(traj),
                                     cmd, stats=stats)
    return tres, jres, stats


def _decoded(res):
    from skellysim_tpu_torch.io import eigen

    return eigen.decode_tree(res)


def test_process_request_matches_jax(listener_run):
    tres, jres, stats = _both(listener_run, _request())
    t, j = _decoded(tres), _decoded(jres)
    assert (t["time"], t["i_frame"], t["n_frames"]) == (
        j["time"], j["i_frame"], j["n_frames"])
    for kind in ("streamlines", "vortexlines"):
        for a, b in zip(t[kind], j[kind]):
            a = {k: np.atleast_2d(v) for k, v in a.items()}
            b = {k: np.atleast_2d(v) for k, v in b.items()}
            assert a["x"].shape == b["x"].shape, (
                f"{kind}: the integrators took other steps "
                f"({a['x'].shape} against {b['x'].shape})")
            for k in ("x", "val", "time"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9)
        assert len(t[kind]) == len(j[kind])
    np.testing.assert_allclose(t["velocity_field"], j["velocity_field"],
                               rtol=0, atol=1e-9)
    assert stats["steps"] > 0 and stats["calls"] > 6


def _serve(path, traj, *frames):
    buf = b"".join(protocol.HEADER.pack(len(f)) + f for f in frames)
    out = _io.BytesIO()
    tlistener.serve(path, traj, stdin=_io.BytesIO(buf), stdout=out,
                    device="cpu")
    out.seek(0)
    answers = []
    while True:
        f = protocol.read_frame(out)
        if f is None:
            return answers
        answers.append(f)


def test_serve_switches_refuses_and_goes_on(listener_run):
    """Through `serve`: a "tree" request agrees with the dense one to the
    tree's tolerance, an invalid frame and an unknown evaluator are each
    answered empty, and the request after them is answered."""
    path, traj = listener_run
    pack = protocol.pack_message
    fr = _serve(path, traj, pack(_request(evaluator="CPU")),
                pack(_request(evaluator="tree")),
                pack(_request(frame_no=999)),
                pack(_request(evaluator="nonsense")),
                pack(_request(frame_no=0)), b"")
    assert [len(f) > 0 for f in fr] == [True, True, False, False, True]
    dense, tree = (protocol.unpack_message(f) for f in fr[:2])
    ref = np.asarray(dense["velocity_field"])
    np.testing.assert_allclose(np.asarray(tree["velocity_field"]), ref,
                               rtol=0, atol=1e-3 * np.abs(ref).max())
    assert protocol.unpack_message(fr[4])["i_frame"] == 0


def test_framing_both_ways_between_the_packages():
    msg = {"frame_no": 3, "evaluator": "FMM", "flag": True, "none": None,
           "neg": -70000, "big": 1 << 40, "f": 0.25, "s": "x" * 40,
           "nested": {"x0": np.arange(12.0).reshape(4, 3),
                      "v": np.arange(5.0), "m": np.arange(8.0).reshape(2, 4).T,
                      "list": [1, 2.5, "a"]}}
    for pack, unpack in ((protocol.pack_message, jprotocol.unpack_message),
                         (jprotocol.pack_message, protocol.unpack_message)):
        got = unpack(pack(msg))
        assert set(got) == set(msg)
        for k in ("frame_no", "evaluator", "flag", "none", "neg", "big", "f",
                  "s"):
            assert got[k] == msg[k]
        assert got["nested"]["list"] == msg["nested"]["list"]
        for k in ("x0", "v", "m"):
            np.testing.assert_array_equal(got["nested"][k], msg["nested"][k])
    # the streams: a frame, the empty frame, then the end of the stream
    buf = _io.BytesIO()
    protocol.write_message(buf, {"a": 1})
    jprotocol.write_empty(buf)
    buf.seek(0)
    assert jprotocol.read_message(buf) == {"a": 1}
    assert protocol.read_frame(buf) == b""
    assert protocol.read_frame(buf) is None
    # the request schema both packages validate alike
    for req in ({"type": "status", "tenant": "a"}, {"type": "status"},
                {"type": "nope"}, {"type": "stats", "x": 1}, []):
        assert (protocol.validate_request(req) is None) == (
            jprotocol.validate_request(req) is None)
    assert protocol.make_request("cancel", tenant="t") == {
        "type": "cancel", "tenant": "t"}
    dec = protocol.FrameDecoder(max_frame_bytes=16)
    frames = dec.feed(protocol.HEADER.pack(32) + b"z" * 32
                      + protocol.HEADER.pack(2) + b"ok")
    assert isinstance(frames[0], protocol.OversizedFrame)
    assert frames[1:] == [b"ok"]


def test_listener_client_round_trip(listener_run, tmp_path):
    from skellysim_tpu_torch.io import Listener, Request, VelocityFieldRequest

    path, _ = listener_run
    env = dict(os.environ, PYTHONPATH=REPO)
    err = open(tmp_path / "server.err", "w")
    lis = Listener(toml_file=path, device="cpu", stderr=err, env=env)
    try:
        req = Request(frame_no=1)
        req.velocity_field = VelocityFieldRequest(
            x=np.array([[60.0, 0.0, 0.0], [0.0, 70.0, 0.0]]))
        res = lis.request(req)
        assert res["i_frame"] == 1 and res["n_frames"] >= 2
        np.testing.assert_allclose(np.asarray(res["velocity_field"]),
                                   [[0.5, 0.0, 0.0]] * 2, atol=5e-2)
        assert lis.request(Request(frame_no=512)) is None
    finally:
        rc = lis.close(timeout=60)
        err.close()
    assert rc == 0, open(tmp_path / "server.err").read()
    assert "listener request" in open(tmp_path / "server.err").read()
