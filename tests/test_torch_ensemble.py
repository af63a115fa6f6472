"""The port's ensemble against the JAX package's.

The member-batched GMRES keeps each member's solo iterations and solution
(a port of `tests/test_ensemble.py::test_gmres_vmap_masked_convergence`);
the member-batched plain twins of kernels A-D give the lone twins' bits
member by member; `EnsembleRunner.step` in both plans is within 1e-10 of
the JAX package's ``"vmap"`` step per member with the same iterations and
the same accept / reject / dt ladder (a coupled shell-body-fiber scene, and
an adaptive scene whose first trial is rejected), and ``"unroll"`` gives
the bits of the port's sequential `System.run`; a spectral plan threads
through both plans; `run_ensemble`'s records
equal the JAX package's (events, lanes, backfill order; numbers to 1e-10);
the sweep expansion equals the JAX package's; and the ensemble CLI on
`examples/ensemble_sweep`'s recipe and on a dynamic-instability sweep
writes trajectories within 1e-10 of the JAX ensemble CLI's.
"""

import dataclasses
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from skellysim_tpu.bodies import bodies as jbd
from skellysim_tpu.config import schema as jschema
from skellysim_tpu.config import sweep as jsweep
from skellysim_tpu.ensemble import EnsembleRunner as JRunner
from skellysim_tpu.ensemble import MemberSpec as JMember
from skellysim_tpu.ensemble import lane_state as jlane
from skellysim_tpu.ensemble import run_ensemble as jrun_ensemble
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.io import trajectory as jtraj
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.periphery.precompute import (precompute_body,
                                                precompute_periphery)
from skellysim_tpu.system import BackgroundFlow as JBackground
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch.config import schema as tschema
from skellysim_tpu_torch.config import sweep as tsweep
from skellysim_tpu_torch.ensemble import EnsembleRunner as TRunner
from skellysim_tpu_torch.ensemble import EnsembleScheduler
from skellysim_tpu_torch.ensemble import MemberSpec as TMember
from skellysim_tpu_torch.ensemble import lane_state as tlane
from skellysim_tpu_torch.ensemble import run_ensemble as trun_ensemble
from skellysim_tpu_torch.io.trajectory import frame_bytes
from skellysim_tpu_torch.ops import cuda_kernels as ck
from skellysim_tpu_torch.ops import kernels as tk
from skellysim_tpu_torch.solver import (gmres, gmres_batched, gmres_ir,
                                        gmres_ir_batched)
from torch_jax_state import port_state, port_system

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the solver

def test_gmres_batched_masked_convergence():
    """Members of worsening conditioning take different iterations; each
    gets its solo iterations, and its solo x to 1e-9 (here bit for bit:
    the batched matvec is the solo one a row). The same for the
    refinement ladder of `gmres_ir_batched`."""
    rng = np.random.default_rng(11)
    n, B = 24, 3
    As, bs = [], []
    for i in range(B):
        Q = rng.standard_normal((n, n)) / np.sqrt(n)
        As.append(torch.as_tensor(np.eye(n) + (0.1 + 0.4 * i) * Q))
        bs.append(torch.as_tensor(rng.standard_normal(n)))
    b = torch.stack(bs)

    def mv(v):
        return torch.stack([As[i] @ v[i] for i in range(B)])

    batched = gmres_batched(mv, b, tol=1e-12, restart=30, maxiter=90)
    solo = [gmres(lambda v, A=A: A @ v, bi, tol=1e-12, restart=30,
                  maxiter=90) for A, bi in zip(As, bs)]
    assert len({r.iters for r in solo}) > 1
    for i, r in enumerate(solo):
        assert batched.iters[i] == r.iters and batched.converged[i]
        np.testing.assert_allclose(batched.x[i].numpy(), r.x.numpy(),
                                   rtol=1e-9, atol=1e-12)
        assert torch.equal(batched.x[i], r.x)
    lo = [A.float().double() for A in As]

    def mv_lo(v):
        return torch.stack([lo[i] @ v[i] for i in range(B)])

    ir = gmres_ir_batched(mv, mv_lo, b, tol=1e-12, inner_tol=1e-4,
                          restart=30, maxiter=90)
    for i in range(B):
        r = gmres_ir(lambda v, A=As[i]: A @ v, lambda v, A=lo[i]: A @ v,
                     bs[i], tol=1e-12, inner_tol=1e-4, restart=30,
                     maxiter=90)
        assert (ir.iters[i], ir.refines[i]) == (r.iters, r.refines)
        assert torch.equal(ir.x[i], r.x)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_batched_plain_twins_give_lone_bits(prec):
    """A-D's member-batched plain twins, and `ops.kernels` with a leading
    member axis, give the lone plain twins' bits member by member."""
    dt = {"f32": torch.float32, "f64": torch.float64}[prec]
    g = torch.Generator().manual_seed(3)
    B, ns, nt = 3, 70, 45
    src = torch.rand((B, ns, 3), dtype=dt, generator=g)
    trg = torch.cat([src[:, :20], torch.rand((B, nt - 20, 3), dtype=dt,
                                             generator=g)], dim=1)
    f = torch.rand((B, ns, 3), dtype=dt, generator=g)
    S = torch.rand((B, ns, 3, 3), dtype=dt, generator=g)
    for family, pay in (("stokeslet", f), ("stresslet", S)):
        batched = getattr(ck, f"{family}_{prec}_batched_plain")
        lone = getattr(ck, f"{family}_{prec}_plain")
        out = batched(src, trg, pay, 0.8)
        direct = getattr(tk, f"{family}_direct")(src, trg, pay, 0.8)
        for m in range(B):
            want = lone(src[m], trg[m], pay[m], 0.8)
            assert torch.equal(out[m], want) and torch.equal(direct[m], want)


# ------------------------------------------------------------- the runner

def _coupled_jax():
    """A 40-node sphere shell around a 40-node body with 2 bound 8-node
    fibers and 2 free ones; three members shifted apart."""
    p = JParams(eta=1.0, dt_initial=0.01, t_final=0.05, gmres_tol=1e-10,
                adaptive_timestep_flag=False)
    shape = jperi.PeripheryShape(kind="sphere", radius=2.5)
    jsys = JSystem(p, shell_shape=shape)
    d = precompute_periphery("sphere", n_nodes=40, radius=2.5, eta=1.0)
    shell = jperi.make_state(d["nodes"], d["normals"],
                             d["quadrature_weights"],
                             d["stresslet_plus_complementary"], d["M_inv"])
    pre = precompute_body("sphere", 40, radius=0.5)
    u = np.random.default_rng(2).standard_normal((2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.array([0.0, 0.0, -0.8])
    body = jbd.make_group(pre["node_positions_ref"], pre["node_normals_ref"],
                          pre["node_weights"], position=pos[None],
                          nucleation_sites_ref=0.5 * u[None], radius=0.5)
    t = np.linspace(0.0, 0.6, 8)
    bound = (pos + 0.5 * u)[:, None] + t[None, :, None] * u[:, None]
    states = []
    for m in range(3):
        free = (np.array([[0.3 * m, 0.2, 0.5], [-0.4, 0.1 * m, 0.6]])[:, None]
                + t[None, :, None] * np.array([0.0, 0.6, 0.8]))
        g = jfc.make_group(np.concatenate([bound, free]), lengths=0.6,
                           bending_rigidity=0.01, radius=0.0125,
                           force_scale=-0.05,
                           minus_clamped=np.arange(4) < 2,
                           binding_body=np.where(np.arange(4) < 2, 0, -1),
                           binding_site=np.where(np.arange(4) < 2,
                                                 np.arange(4), -1))
        states.append(jsys.make_state(fibers=g, shell=shell, bodies=body))
    return jsys, states


def _free_jax(adaptive):
    """Three members of two free 8-node fibers in a background flow; with
    ``adaptive`` the fiber-error tolerance sits between member 0's first
    trial error and the others', so member 0's first trial is rejected (and
    its dt halved) while the others are accepted and grow their dt."""
    p = JParams(eta=1.0, dt_initial=0.02, dt_max=0.04, t_final=1.0,
                gmres_tol=1e-10, adaptive_timestep_flag=False)
    jsys = JSystem(p)
    t = np.linspace(0.0, 1.0, 8)
    states = []
    for m in range(3):
        x = (np.array([[0.0, 0.1 * m, 0.0], [0.5, 0.0, 0.2]])[:, None]
             + t[None, :, None] * np.array([[0.0, 0.6, 0.8],
                                            [0.8, 0.0, 0.6]])[:, None])
        g = jfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                           radius=0.0125, force_scale=-2.0)
        states.append(jsys.make_state(
            fibers=g, background=JBackground.make(uniform=(0.2, 0.0, 0.0),
                                                  scale=(0.0, 0.0, 5.0))))
    if adaptive:
        # the port's step stands in for the JAX package's to size the
        # tolerance (the runner test holds the two together)
        tsys = port_system(jsys)
        errs = [tsys.step(port_state(s))[2].fiber_error for s in states]
        assert errs[0] > max(errs[1:]) / 0.9
        tol = 0.5 * (errs[0] + max(errs[1:]) / 0.9)
        jsys = JSystem(dataclasses.replace(p, adaptive_timestep_flag=True,
                                           fiber_error_tol=tol,
                                           beta_down=0.5))
    return jsys, states


_SCENES = {"coupled": lambda: _coupled_jax(),
           "adaptive_reject": lambda: _free_jax(adaptive=True)}


@pytest.fixture(scope="module", params=sorted(_SCENES))
def jax_rounds(request):
    """Two rounds of the JAX package's "vmap" runner on a scene."""
    jsys, states = _SCENES[request.param]()
    runner = JRunner(jsys, batch_impl="vmap")
    ens = runner.make_ensemble(states, [1.0] * len(states))
    rounds = []
    for _ in range(2):
        ens, info = runner.step(ens)
        rounds.append((ens, info))
    return request.param, jsys, states, rounds


@pytest.mark.parametrize("impl", ["vmap", "unroll"])
def test_runner_step_matches_jax(jax_rounds, impl):
    """Each member after each of two rounds: fibers, shell density and body
    placement within 1e-10 of the JAX package's vmap step, the same GMRES
    iterations, acceptance, dt and time (the ladder in f64, exact), and
    solutions within 1e-10 of their largest entry."""
    name, jsys, jstates, rounds = jax_rounds
    tsys = port_system(jsys)
    runner = TRunner(tsys, batch_impl=impl)
    ens = runner.make_ensemble([port_state(s) for s in jstates],
                               [1.0] * len(jstates))
    accepted = []
    for jens, jinfo in rounds:
        ens, info = runner.step(ens)
        np.testing.assert_array_equal(info.iters, np.asarray(jinfo.iters))
        np.testing.assert_array_equal(info.accepted,
                                      np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(info.dt_next,
                                      np.asarray(jinfo.dt_next))
        np.testing.assert_array_equal(info.t, np.asarray(jinfo.t))
        accepted.append(info.accepted.copy())
        js = np.asarray(jinfo.solutions)
        np.testing.assert_allclose(info.solutions.numpy(), js, rtol=0,
                                   atol=1e-10 * np.abs(js).max())
        for m in range(len(jstates)):
            j, t = jlane(jens.states, m), tlane(ens.states, m)
            np.testing.assert_allclose(t.fibers.x.numpy(),
                                       np.asarray(j.fibers.x), rtol=0,
                                       atol=1e-10)
            if j.shell is not None:
                np.testing.assert_allclose(
                    t.shell.density.numpy(), np.asarray(j.shell.density),
                    rtol=0, atol=1e-10)
            if j.bodies is not None:
                np.testing.assert_allclose(
                    t.bodies.position.numpy(), np.asarray(j.bodies.position),
                    rtol=0, atol=1e-10)
    if name == "adaptive_reject":
        assert accepted[0].tolist() == [False, True, True]


def test_spectral_plan_threads_through_both_plans():
    """A periodic scene through "spectral": the runner builds one plan from
    the first member and threads it; each member's "unroll" round is its
    solo `System.trial_step` with that plan bit for bit, and its "vmap"
    round within 1e-12 of it at the same iterations."""
    from skellysim_tpu_torch.fibers import container as tfc
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System

    p = Params(dt_initial=0.01, t_final=0.05, gmres_tol=1e-10,
               solver_precision="full", pair_evaluator="spectral",
               periodic_box=(4.0, 4.0, 4.0), adaptive_timestep_flag=False)
    system = System(p, device="cpu")
    t = np.linspace(0.0, 1.0, 8)[:, None]
    states = []
    for m in range(2):
        x = np.stack([[1.0 + 0.2 * m, 1.0, 1.0] + t * [0.6, 0.0, 0.8],
                      [2.5, 2.0, 1.5] + t * [0.0, 0.6, 0.8]])
        states.append(system.make_state(fibers=tfc.make_group(
            x, lengths=1.0, bending_rigidity=0.01, radius=0.0125,
            force_scale=-0.5)))
    pair = system._pair_args(states[0])
    solo = [system.trial_step(s, pair=pair) for s in states]
    for impl in ("unroll", "vmap"):
        runner = TRunner(system, batch_impl=impl)
        ens, info = runner.step(runner.make_ensemble(states, [1.0, 1.0]))
        for m, (new, _, sinfo) in enumerate(solo):
            x = tlane(ens.states, m).fibers.x
            assert info.iters[m] == sinfo.iters
            if impl == "unroll":
                assert torch.equal(x, new.fibers.x)
            else:
                np.testing.assert_allclose(x.numpy(), new.fibers.x.numpy(),
                                           rtol=0, atol=1e-12)


@pytest.mark.parametrize("evaluator", ["ewald", "tree"])
@pytest.mark.parametrize("impl", ["vmap", "unroll"])
def test_runner_refuses_rebuilt_plans(evaluator, impl):
    """Both plans refuse the evaluators whose plan is rebuilt each step, as
    the JAX package's runner does."""
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System

    with pytest.raises(ValueError, match="does not support pair_evaluator"):
        TRunner(System(Params(pair_evaluator=evaluator), device="cpu"),
                batch_impl=impl)


def test_unroll_gives_sequential_run_bits():
    """Each member of a sweep through the "unroll" plan, lanes backfilled,
    writes the bytes of frames the port's sequential `System.run` writes
    for it."""
    jsys, jstates = _free_jax(adaptive=False)
    tsys = port_system(jsys)
    tsys.params = dataclasses.replace(tsys.params, dt_write=0.02)
    finals = [0.04, 0.06, 0.02]
    members = [TMember(member_id=f"m{i}", state=port_state(s),
                       t_final=tf)
               for i, (s, tf) in enumerate(zip(jstates, finals))]
    frames = {m.member_id: [] for m in members}
    EnsembleScheduler(
        TRunner(tsys, batch_impl="unroll"), members, 2,
        writer=lambda mid, s, rng_state=None: frames[mid].append(
            frame_bytes(s))).run()
    for m in members:
        solo = port_system(jsys)
        solo.params = dataclasses.replace(tsys.params, t_final=m.t_final)
        seq = []
        solo.run(m.state,
                 writer=lambda s, sol, **kw: seq.append(frame_bytes(s)))
        assert frames[m.member_id] == seq and len(seq) >= 1


_RECORD_EXACT = ("event", "member", "lane", "round", "step", "iters",
                 "gmres_cycles", "accepted", "refines", "health",
                 "nucleations", "catastrophes", "active_fibers",
                 "loss_of_accuracy", "steps", "frames")
_RECORD_CLOSE = ("t", "dt", "residual", "residual_true", "fiber_error",
                 "t_final")


def test_run_ensemble_records_match_jax():
    """Four members through two lanes (so lanes retire and backfill): the
    same records in the same order, integer and event fields equal, times,
    dt, relative residuals and fiber errors within 1e-10."""
    jsys, jstates = _free_jax(adaptive=False)
    finals = [0.04, 0.02, 0.06, 0.04]
    jstates = jstates + [jstates[0]._replace(
        fibers=jstates[0].fibers._replace(x=jstates[0].fibers.x + 0.05))]
    out = {}
    for who in ("jax", "port"):
        recs = []
        if who == "jax":
            members = [JMember(member_id=f"m{i}", state=s, t_final=tf)
                       for i, (s, tf) in enumerate(zip(jstates, finals))]
            jrun_ensemble(jsys, members, batch=2, metrics=recs.append)
        else:
            members = [TMember(member_id=f"m{i}", state=port_state(s),
                               t_final=tf)
                       for i, (s, tf) in enumerate(zip(jstates, finals))]
            trun_ensemble(port_system(jsys), members, batch=2,
                          metrics=recs.append)
        out[who] = recs
    assert len(out["port"]) == len(out["jax"])
    for rj, rt in zip(out["jax"], out["port"]):
        assert set(rt) == set(rj)
        for k in _RECORD_EXACT:
            if k in rj:
                assert rt[k] == rj[k], (k, rj)
        for k in _RECORD_CLOSE:
            if k in rj:
                assert abs(rt[k] - rj[k]) <= 1e-10, (k, rj)
    assert [r["event"] for r in out["port"] if r["event"] != "step"] == [
        r["event"] for r in out["jax"] if r["event"] != "step"]


# -------------------------------------------------------------- the sweep

_SWEEP = """\
[ensemble]
base_config = "skelly_config.toml"
replicas = 2
batch = 3
seed = 9

[[ensemble.sweep]]
key = "fibers.0.bending_rigidity"
values = [0.0025, 0.005]

[[ensemble.sweep]]
key = "params.t_final"
values = [0.02, 0.0]
"""


def test_sweep_expansion_matches_jax(tmp_path):
    """`load_sweep`, `expand_members` and `apply_overrides` equal the JAX
    package's; a Params key outside the two per-member ones is refused by
    both."""
    from skellysim_tpu_torch.config import Config, Fiber

    cfg = Config()
    f = Fiber(n_nodes=8, length=1.0)
    f.fill_node_positions(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    cfg.fibers = [f]
    cfg.save(str(tmp_path / "skelly_config.toml"))
    sweep = tmp_path / "ensemble.toml"
    sweep.write_text(_SWEEP)
    jspec, jbase_path, jbase, jplans = jsweep.load_members(str(sweep))
    tspec, tbase_path, tbase, tplans = tsweep.load_members(str(sweep))
    assert tbase_path == jbase_path
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert ([dataclasses.asdict(p) for p in tplans]
            == [dataclasses.asdict(p) for p in jplans])
    for jp, tp in zip(jplans, tplans):
        jc = jsweep.apply_overrides(jbase, jp.overrides)
        tc = tsweep.apply_overrides(tbase, tp.overrides)
        assert (tschema.unpack(tc)["fibers"]
                == jschema.unpack(jc)["fibers"])
    for mod, base in ((jsweep, jbase), (tsweep, tbase)):
        with pytest.raises(ValueError, match="sweep key 'params.eta' "
                           "changes the static runtime Params"):
            mod.apply_overrides(base, {"params.eta": 2.0})


# ---------------------------------------------------------------- the CLI

def _example_recipe(d):
    """`examples/ensemble_sweep/gen_config.py` in ``d``, its sweep cut to
    10 steps a member (t_final 0.1: frames at 0, 0.05 and 0.1)."""
    cwd = os.getcwd()
    argv = sys.argv
    try:
        os.chdir(d)
        sys.argv = ["gen_config.py"]
        runpy.run_path(os.path.join(REPO, "examples", "ensemble_sweep",
                                    "gen_config.py"), run_name="__main__")
    finally:
        os.chdir(cwd)
        sys.argv = argv
    spec = (d / "ensemble.toml").read_text()
    (d / "ensemble.toml").write_text(spec.replace(
        "batch = 8\n", "batch = 8\nt_final = 0.1\n"))


def _di_recipe(d):
    """A dynamic-instability sweep: a 40-node body with 6 sites, DI at 8
    nodes on one 16-slot capacity rung (`[runtime] bucket_ladder`), 3
    replicas through 2 lanes (one backfill), 2 rounds."""
    from skellysim_tpu import precompute as jprecompute
    from skellysim_tpu_torch.config import Body, Config

    cfg = Config()
    cfg.params.eta = 1.0
    cfg.params.dt_initial = 0.05
    cfg.params.dt_write = 0.05
    cfg.params.t_final = 0.1
    cfg.params.adaptive_timestep_flag = False
    cfg.params.seed = 3
    di = cfg.params.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = 8, 0.2, 0.5
    di.nucleation_rate, di.min_length = 8.0, 0.4
    di.radius, di.bending_rigidity = 0.0125, 0.01
    sites = np.random.default_rng(11).standard_normal((6, 3))
    sites = 0.5 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
    cfg.bodies = [Body(position=[0.0, 0.0, 0.0], shape="sphere", radius=0.5,
                       n_nodes=40, nucleation_sites=sites.ravel().tolist())]
    cfg.save(str(d / "skelly_config.toml"))
    with open(d / "skelly_config.toml", "a") as fh:
        # one capacity rung for the whole sweep
        fh.write("\n[runtime]\nbucket_ladder = [16]\n")
    jprecompute.precompute_from_config(str(d / "skelly_config.toml"),
                                       verbose=False)
    (d / "ensemble.toml").write_text(
        '[ensemble]\nbase_config = "skelly_config.toml"\nreplicas = 3\n'
        "batch = 2\n")


def _member_frames(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".out"):
            r = jtraj.TrajectoryReader(str(d / name))
            out[name] = [r.load_frame(i) for i in range(len(r))]
            r.close()
    return out


@pytest.fixture(scope="module")
def jax_cli_runs(tmp_path_factory):
    """Each recipe through the JAX package's ensemble CLI ("vmap"), once:
    (source directory, member frames)."""
    from skellysim_tpu.ensemble import cli as jcli

    out = {}
    for recipe, make in (("example", _example_recipe), ("di", _di_recipe)):
        root = tmp_path_factory.mktemp(recipe)
        src = root / "src"
        src.mkdir()
        make(src)
        d = root / "jax"
        shutil.copytree(src, d)
        jcli.run(str(d / "ensemble.toml"), batch_impl="vmap")
        out[recipe] = (src, _member_frames(d))
    return out


@pytest.mark.parametrize("recipe,impl", [("example", "vmap"),
                                         ("di", "vmap"), ("di", "unroll")])
def test_ensemble_cli_matches_jax(tmp_path, jax_cli_runs, recipe, impl):
    """Both packages' ensemble CLIs on one sweep: the same member files,
    frames, times, RNG states and fiber counts, positions within 1e-10,
    and a start, step and retire record a member in the port's metrics."""
    from skellysim_tpu_torch.ensemble import cli as tcli

    src, jf = jax_cli_runs[recipe]
    d = tmp_path / "port"
    shutil.copytree(src, d)
    tcli.run(str(d / "ensemble.toml"), batch_impl=impl, device="cpu")
    tf = _member_frames(d)
    assert sorted(tf) == sorted(jf) and len(tf) >= 3
    for name in jf:
        assert len(tf[name]) == len(jf[name]) >= 2
        for fa, fb in zip(jf[name], tf[name]):
            assert fb["time"] == fa["time"]
            assert fb["rng_state"] == fa["rng_state"]
            a, b = fa["fibers"][1], fb["fibers"][1]
            assert len(a) == len(b)
            for ma, mb in zip(a, b):
                np.testing.assert_allclose(np.asarray(mb["x_"]),
                                           np.asarray(ma["x_"]), rtol=0,
                                           atol=1e-10)
    if recipe == "di":
        assert any(len(f[-1]["fibers"][1]) for f in tf.values())
    recs = [json.loads(line) for line in
            open(d / "ensemble_metrics.jsonl")]
    for name in tf:
        mid = name[:-4]
        events = {r["event"] for r in recs if r["member"] == mid}
        assert {"start", "step", "retire"} <= events
