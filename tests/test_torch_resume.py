"""The port's `--resume` side against the JAX package's.

* each package's reader on the other's trajectory finds the same frame
  offsets and times, and a `.cindex` written by either is taken by the
  other without a rebuild;
* `frame_to_state` rebuilds the same fibers (two resolutions, inactive
  slots dropped), the mixed body-kind order of
  `tests/test_trajectory.py::test_resume_mixed_body_kind_order` and the
  shell density as the JAX one, bit for bit;
* the port's twin of `test_resume_roundtrip`: the resumed state steps like
  the original to 1e-12;
* the CLIs on the dynamic-instability scene of
  `tests/test_resume_dynamic_instability.py`: one package writes two steps,
  then each package resumes its own copy of that trajectory for two more
  (the JAX package is the oracle): the same appended times, fiber counts
  and bindings, positions within 1e-10, and the metrics file's resume
  marker;
* the CLI's guards: ``--resume`` without a trajectory exits, and a
  `[runtime]` capacity ladder raises instead of being ignored.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu import cli as jcli
from skellysim_tpu import precompute as jprecompute
from skellysim_tpu.bodies import bodies as jbd
from skellysim_tpu.config import Body, Config
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.io import eigen as jeigen
from skellysim_tpu.io import trajectory as jtraj
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.periphery.precompute import precompute_body
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch import cli as tcli
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.io import trajectory as ttraj
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.system import BackgroundFlow, System


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()
            if v is not None}


def _jax_fibers(nf, n, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((nf, n, 3)) * 0.05, axis=1)
    g = jfc.make_group(x, lengths=rng.uniform(0.8, 1.2, nf),
                       bending_rigidity=0.01, radius=0.0125,
                       minus_clamped=rng.random(nf) > 0.5)
    return g._replace(tension=jnp.asarray(rng.standard_normal((nf, n))))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_agree_across_packages(tmp_path, writer, monkeypatch):
    path = str(tmp_path / "skelly_sim.out")
    g = _jax_fibers(3, 16, seed=1)
    jstate = JSystem(JParams()).make_state(fibers=g)
    tstate = convert.state_from_numpy(_leaves(g), time=0.0, dt=0.01,
                                      device="cpu")
    if writer == "jax":
        with jtraj.TrajectoryWriter(path) as tw:
            for k in range(4):
                tw.write_frame(jstate._replace(time=jnp.float64(0.25 * k)),
                               rng_state=[["shared", f"1:0:{k}"]])
    else:
        with ttraj.TrajectoryWriter(path) as tw:
            for k in range(4):
                tw.write_frame(tstate._replace(time=0.25 * k),
                               rng_state=[["shared", f"1:0:{k}"]])
    # the port builds the index; the JAX reader must take it as it is
    tr = ttraj.TrajectoryReader(path)
    monkeypatch.setattr(jtraj, "build_index", _refuse)
    jr = jtraj.TrajectoryReader(path)
    assert tr._offsets == jr._fpos and tr.times == jr.times
    assert tr.times == [0.0, 0.25, 0.5, 0.75]
    for i in (0, 3):
        a, b = tr.load_frame(i), jr.load_frame(i)
        assert a["rng_state"] == b["rng_state"]
        for fa, fb in zip(a["fibers"][1], b["fibers"][1]):
            np.testing.assert_array_equal(fa["x_"], fb["x_"])
    tr.close()
    jr.close()
    # and the other way: an index the JAX package wrote
    monkeypatch.undo()
    jtraj.build_index(path)
    monkeypatch.setattr(ttraj, "build_index", _refuse)
    with ttraj.TrajectoryReader(path) as tr2:
        assert tr2._offsets == tr._offsets and tr2.times == tr.times


def _refuse(*a, **k):
    raise AssertionError("the index was rebuilt")


def _mixed_scene():
    """Two fiber resolutions (one slot inactive), an ellipsoid body before a
    sphere body (the wire puts the sphere first), and a small shell."""
    g16 = _jax_fibers(4, 16, seed=2)._replace(
        active=jnp.asarray([True, False, True, True]),
        config_rank=jnp.asarray([0, 1, 3, 5], jnp.int32))
    g8 = _jax_fibers(2, 8, seed=3)._replace(
        config_rank=jnp.asarray([2, 4], jnp.int32))
    pre = precompute_body("sphere", 100, radius=0.5)
    bodies = jbd.make_group(
        np.stack([pre["node_positions_ref"]] * 2),
        np.stack([pre["node_normals_ref"]] * 2),
        np.stack([pre["node_weights"]] * 2),
        position=np.array([[1.0, 0, 0], [2.0, 0, 0]]), radius=0.5)
    bodies = bodies._replace(kind_sphere=jnp.asarray([False, True]))
    rng = np.random.default_rng(4)
    n = 20
    nodes = rng.standard_normal((n, 3))
    shell = jperi.make_state(nodes, -nodes, np.full(n, 0.1),
                             rng.standard_normal((3 * n, 3 * n)),
                             np.eye(3 * n))
    shape = jperi.PeripheryShape(kind="generic")
    jsys = JSystem(JParams(), shell_shape=shape)
    jstate = jsys.make_state(fibers=(g16, g8), bodies=bodies, shell=shell)
    tstate = convert.state_from_numpy(
        [_leaves(g16), _leaves(g8)], time=0.0, dt=float(jstate.dt),
        bodies=_leaves(bodies), shell=_leaves(shell), device="cpu")
    return jstate, tstate


def test_frame_to_state_matches_jax():
    jstate, tstate = _mixed_scene()
    rng = np.random.default_rng(5)
    moved = jstate._replace(
        time=jnp.float64(0.75), dt=jnp.float64(0.01),
        bodies=jstate.bodies._replace(
            position=jstate.bodies.position + 0.5,
            solution=jnp.asarray(rng.standard_normal(
                jstate.bodies.solution.shape))),
        shell=jstate.shell._replace(
            density=jnp.asarray(rng.standard_normal(60))))
    frame = jeigen.decode_tree(jtraj.state_to_frame(moved))
    a = jtraj.frame_to_state(frame, jstate)
    b = ttraj.frame_to_state(frame, tstate)
    assert b.time == float(a.time) == 0.75 and b.dt == float(a.dt)
    ja, tb = jfc.as_buckets(a.fibers), tfc.as_buckets(b.fibers)
    assert [g.n_fibers for g in tb] == [g.n_fibers for g in ja] == [3, 2]
    for jg, tg in zip(ja, tb):
        for name, leaf in _leaves(jg).items():
            np.testing.assert_array_equal(getattr(tg, name).numpy(), leaf,
                                          err_msg=name)
        assert tg.config_rank.dtype == torch.int32
    for name in ("position", "orientation", "solution"):
        np.testing.assert_array_equal(getattr(b.bodies, name).numpy(),
                                      np.asarray(getattr(a.bodies, name)))
    np.testing.assert_array_equal(b.bodies.position.numpy(),
                                  np.asarray(moved.bodies.position))
    np.testing.assert_array_equal(b.shell.density.numpy(),
                                  np.asarray(moved.shell.density))


def test_resume_roundtrip(tmp_path):
    path = str(tmp_path / "skelly_sim.out")
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((3, 16, 3)) * 0.05, axis=1)
    system = System(Params(eta=1.0, dt_initial=2.5e-3, t_final=1e-2,
                           gmres_tol=1e-10, adaptive_timestep_flag=False),
                    device="cpu")
    fibers = tfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125)
    fibers = fibers._replace(tension=torch.as_tensor(
        rng.standard_normal((3, 16))))
    state = system.make_state(
        fibers=fibers, background=BackgroundFlow.make(uniform=(0.1, 0.0,
                                                               0.0)))
    new_state = system.step(state)[0]._replace(time=state.time + state.dt)
    with ttraj.TrajectoryWriter(path) as tw:
        tw.write_frame(state)
        tw.write_frame(new_state)
    resumed, rng_state, reader = ttraj.resume_state(path, state)
    reader.close()
    assert rng_state == []
    assert torch.equal(resumed.fibers.x, new_state.fibers.x)
    assert torch.equal(resumed.fibers.tension, new_state.fibers.tension)
    assert resumed.time == pytest.approx(new_state.time)
    a = system.step(resumed)[0]
    b = system.step(new_state)[0]
    np.testing.assert_allclose(a.fibers.x.numpy(), b.fibers.x.numpy(),
                               rtol=0, atol=1e-12)


def _di_config(path, t_final):
    cfg = Config()
    cfg.params.eta = 1.0
    cfg.params.dt_initial = 0.05
    cfg.params.dt_write = 0.05
    cfg.params.t_final = t_final
    cfg.params.adaptive_timestep_flag = False
    cfg.params.seed = 3
    di = cfg.params.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = 16, 0.2, 0.5
    di.nucleation_rate, di.min_length = 50.0, 0.4
    di.radius, di.bending_rigidity = 0.0125, 0.01
    sites = np.random.default_rng(11).standard_normal((12, 3))
    sites = 0.5 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
    cfg.bodies = [Body(position=[0.0, 0.0, 0.0], shape="sphere", radius=0.5,
                       n_nodes=100, nucleation_sites=sites.ravel().tolist())]
    cfg.save(str(path))


def _frames(path):
    r = jtraj.TrajectoryReader(str(path))
    out = [r.load_frame(i) for i in range(len(r))]
    r.close()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_resume_across_packages(tmp_path, writer):
    base = tmp_path / "written"
    base.mkdir()
    cfg = base / "skelly_config.toml"
    _di_config(cfg, t_final=0.1)
    jprecompute.precompute_from_config(str(cfg), verbose=False)
    if writer == "jax":
        jcli.run(str(cfg), metrics_path=str(base / "metrics.jsonl"))
    else:
        tcli.run(str(cfg), metrics_path=str(base / "metrics.jsonl"),
                 device="cpu")
    n_before = len(_frames(base / "skelly_sim.out"))
    assert n_before == 3
    runs = {}
    for who, run in (("jax", lambda c, m: jcli.run(c, resume=True,
                                                   metrics_path=m)),
                     ("port", lambda c, m: tcli.run(c, resume=True,
                                                    metrics_path=m,
                                                    device="cpu"))):
        d = tmp_path / f"resumed_by_{who}"
        shutil.copytree(base, d)
        _di_config(d / "skelly_config.toml", t_final=0.2)
        run(str(d / "skelly_config.toml"), str(d / "metrics.jsonl"))
        lines = [json.loads(line) for line in open(d / "metrics.jsonl")]
        markers = [m for m in lines if m.get("resume")]
        assert len(markers) == 1 and markers[0]["t"] == pytest.approx(0.1)
        runs[who] = (_frames(d / "skelly_sim.out"), lines)
    (jf, jm), (tf, tm) = runs["jax"], runs["port"]
    assert len(jf) == len(tf) == n_before + 2
    assert [f["time"] for f in tf] == [f["time"] for f in jf]
    assert tf[n_before]["time"] > tf[n_before - 1]["time"]
    assert sum(len(f["fibers"][1]) for f in tf) > 0
    for fa, fb in zip(jf, tf):
        assert fa["rng_state"] == fb["rng_state"]
        a, b = fa["fibers"][1], fb["fibers"][1]
        assert len(a) == len(b)
        for ma, mb in zip(a, b):
            assert ma["binding_site_"] == mb["binding_site_"]
            np.testing.assert_allclose(mb["x_"], ma["x_"], rtol=0,
                                       atol=1e-10)
    keys = ("nucleations", "catastrophes", "active_fibers", "iters")
    assert ([[m[k] for k in keys] for m in tm if "step" in m]
            == [[m[k] for k in keys] for m in jm if "step" in m])


def test_cli_guards(tmp_path, caplog):
    """--resume without a trajectory exits, as in the JAX CLI; a
    `[runtime]` capacity ladder is read as the JAX CLI reads it: with
    ``bucket_ladder = [-1]`` and no precompute both CLIs raise the same
    missing-precompute error, a malformed ladder the same ValueError, and
    after the precompute the geometric ladder lands the run on its rung."""
    cfg = tmp_path / "skelly_config.toml"
    _di_config(cfg, t_final=0.1)
    with pytest.raises(SystemExit, match="does not exist"):
        tcli.run(str(cfg), resume=True, device="cpu")
    with open(cfg, "a") as fh:
        fh.write("\n[runtime]\nbucket_ladder = [-1]\n")
    with pytest.raises(FileNotFoundError) as je:
        jcli.run(str(cfg))
    with pytest.raises(FileNotFoundError) as te:
        tcli.run(str(cfg), device="cpu")
    assert str(te.value).split("(")[0] == str(je.value).split("(")[0]
    jprecompute.precompute_from_config(str(cfg), verbose=False)
    bad = tmp_path / "bad.toml"
    bad.write_text(cfg.read_text().replace("bucket_ladder = [-1]",
                                           "bucket_ladder = [4, 2]"))
    with pytest.raises(ValueError, match="strictly ascending") as je:
        jcli.run(str(bad))
    with pytest.raises(ValueError, match="strictly ascending") as te:
        tcli.run(str(bad), device="cpu")
    assert str(te.value) == str(je.value)
    with caplog.at_level("INFO", logger="skellysim_tpu_torch"):
        tcli.run(str(cfg), device="cpu")
    # no fiber before the first nucleation: an empty bucket, and the
    # nucleated fibers land on a geometric rung
    assert "scene bucket: fibers[none]" in caplog.text
    assert "fiber capacity 16" in caplog.text
