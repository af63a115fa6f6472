"""The port's flight recorder (`obs.flight`) against the JAX package's, on
the CPU in float64.

* window 0: ``state.flight`` is None and the step is the unarmed one; an
  armed step's physics are the unarmed step's bits, and its rows equal the
  JAX package's armed rows (ids exactly, floats within 1e-6; the true
  residual column is each solve's own, rounded to float32) over six steps
  of the coupled scene into a window of 4 (`ring_rows`' chronology);
* provenance of a NaN in the fiber positions, the tensions, the shell
  density and the shell nodes equals JAX's (field, fiber, node) exactly
  (tests/test_flight.py's scenes);
* a rejected trial keeps its row in the run loop, as in the JAX package;
* the ensemble: "vmap" lanes against their "unroll" solo rings, and a
  poisoned lane's failure payload equal to the JAX vmap runner's;
* 4 CPU shards: every shard's ring the same bits, ids equal to the one
  card's, floats within 1e-6;
* `render_flight_report` over one metrics file prints the JAX package's
  text; `record_step` makes no host read (no `.item()`);
* `periphery.signed_clearance` (sphere, ellipsoid, generic) equals JAX's.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.audit import fixtures
from skellysim_tpu.obs import flight as jflight
from skellysim_tpu_torch.obs import flight
from torch_jax_state import port_state, port_system

FIELDS = flight.FLIGHT_FIELDS
IDS = [FIELDS.index(k) for k in ("strain_fiber", "health", "prov_field",
                                 "prov_fiber", "prov_node")]
RES = FIELDS.index("residual_true")
FLOATS = [i for i in range(len(FIELDS)) if i not in IDS and i != RES]


def _rows(ring):
    return ring.rows.numpy(), int(ring.count)


def _same_row(t_row, j_row, t_res=None):
    """ids exactly, floats within 1e-6 relative (NaN where NaN)."""
    t_row, j_row = np.asarray(t_row), np.asarray(j_row)
    np.testing.assert_array_equal(t_row[IDS], j_row[IDS])
    np.testing.assert_allclose(t_row[FLOATS], j_row[FLOATS], rtol=1e-6,
                               atol=0)
    if t_res is not None:
        assert t_row[RES] == np.float32(t_res)


@pytest.fixture(scope="module")
def coupled():
    """Six steps of the coupled scene (the audit fixture's 16 fibers, a
    56-node shell, a forced body) in both packages, armed with a window of
    4, and the port's unarmed twin."""
    js = fixtures.make_system(shell=True, flight_window=4)
    j0 = fixtures.coupled_state(js)
    ts = port_system(js)
    t0 = ts.ensure_flight(port_state(j0))
    off = port_system(fixtures.make_system(shell=True))
    u0 = port_state(j0)
    out = {"js": js, "ts": ts, "off": off, "j0": j0, "t0": t0, "u0": u0,
           "steps": []}
    jst, tst, ust = j0, t0, u0
    for _ in range(6):
        jn, _, ji = js.step(jst)
        tn, tx, ti = ts.step(tst)
        un, ux, ui = off.step(ust)
        out["steps"].append((jn, tn, tx, ti, un, ux, ui))
        jst = jn._replace(time=jn.time + jn.dt)
        tst = tn._replace(time=tn.time + tn.dt)
        ust = un._replace(time=un.time + un.dt)
    return out


def test_window_zero_is_the_unarmed_step(coupled):
    off, u0 = coupled["off"], coupled["u0"]
    assert u0.flight is None and off.ensure_flight(u0).flight is None
    assert off.make_state(fibers=u0.fibers, shell=u0.shell,
                          bodies=u0.bodies).flight is None
    un = coupled["steps"][0][4]
    assert un.flight is None
    ts = coupled["ts"]
    armed = ts.ensure_flight(u0)
    assert armed.flight.rows.shape == (4, len(FIELDS))
    assert int(armed.flight.count) == 0
    assert off.ensure_flight(armed).flight is None
    from skellysim_tpu_torch.system import System

    bigger = System(dataclasses.replace(ts.params, flight_window=8),
                    shell_shape=ts.shell_shape, device="cpu")
    assert bigger.ensure_flight(armed).flight.rows.shape[0] == 8


def test_armed_steps_keep_the_physics_and_match_jax_rows(coupled):
    for jn, tn, tx, ti, un, ux, ui in coupled["steps"]:
        assert torch.equal(tx, ux)
        assert torch.equal(tn.fibers.x, un.fibers.x)
        assert torch.equal(tn.shell.density, un.shell.density)
        assert torch.equal(tn.bodies.solution, un.bodies.solution)
        assert ti == ui
    # the ring after six trials in a window of 4: the last four, oldest
    # first, each row JAX's
    jn, tn, tx, ti = coupled["steps"][-1][:4]
    t_rows = flight.ring_rows(*_rows(tn.flight))
    j_rows = jflight.ring_rows(np.asarray(jn.flight.rows),
                               int(jn.flight.count))
    assert int(tn.flight.count) == 6 and len(t_rows) == 4
    assert [r["t"] for r in t_rows] == [r["t"] for r in j_rows]
    infos = [s[3] for s in coupled["steps"]][2:]
    for k in range(4):
        t_raw = tn.flight.rows.numpy()[(2 + k) % 4]
        j_raw = np.asarray(jn.flight.rows)[(2 + k) % 4]
        _same_row(t_raw, j_raw, infos[k].residual_true)
    last = t_rows[-1]
    assert last["health"] == 0 and last["provenance"] is None
    assert last["body_norm"] > 0 and last["min_clearance"] > 0
    assert flight.last_row(*_rows(tn.flight)) == last


def _poison(state, field, where):
    """tests/test_flight.py's injections, on a JAX state."""
    if field in ("fiber_x", "fiber_tension"):
        x = np.array(state.fibers.x)
        t = np.array(state.fibers.tension)
        fiber, node = where
        if field == "fiber_x":
            x[fiber, node, 1] = np.nan
        else:
            t[fiber, node] = np.inf
        return state._replace(fibers=state.fibers._replace(
            x=jnp.asarray(x), tension=jnp.asarray(t)))
    sh = state.shell
    if field == "shell_nodes":
        nodes = np.array(sh.nodes)
        nodes[where, 2] = np.nan
        return state._replace(shell=sh._replace(nodes=jnp.asarray(nodes)))
    rho = np.array(sh.density)
    rho[where] = np.inf
    return state._replace(shell=sh._replace(density=jnp.asarray(rho)))


@pytest.mark.parametrize("case", [
    [("fiber_x", (2, 3))], [("fiber_x", (0, 7))],
    [("fiber_tension", (1, 5))],
    [("fiber_tension", (1, 5)), ("fiber_x", (2, 3))],
    [("shell_nodes", 5)], [("shell_density", 17)]])
def test_provenance_matches_jax(coupled, case):
    js, ts, j0 = coupled["js"], coupled["ts"], coupled["j0"]
    bad = j0
    for field, where in case:
        bad = _poison(bad, field, where)
    jn, _, ji = js.step(bad)
    tn, _, ti = ts.step(port_state(bad))
    j_row = jflight.last_row(np.asarray(jn.flight.rows), jn.flight.count)
    t_row = flight.last_row(*_rows(tn.flight))
    assert ti.health == int(ji.health)
    assert t_row["provenance"] == j_row["provenance"]
    assert (t_row["prov_field"], t_row["prov_fiber"], t_row["prov_node"]) \
        == (j_row["prov_field"], j_row["prov_fiber"], j_row["prov_node"])
    assert t_row["provenance"]["field"] == case[-1][0]


def test_rejected_trial_keeps_its_row(tmp_path):
    """Under the adaptive gate every trial of a tiny fiber_error_tol is
    rejected: the physics roll back, the ring keeps both rows (dt halving
    by beta_down), in both packages; the metrics column carries them."""
    over = dict(flight_window=4, adaptive_timestep_flag=True,
                fiber_error_tol=1e-30, dt_min=1e-9, t_final=1.0)
    js = fixtures.make_system(**over)
    j0 = fixtures.free_state(js)
    ts = port_system(js)
    t0 = ts.ensure_flight(port_state(j0))
    jend = js.run(j0, max_steps=2)
    metrics = str(tmp_path / "m.jsonl")
    tend = ts.run(t0, max_steps=2, metrics_path=metrics)
    assert torch.equal(tend.fibers.x, t0.fibers.x)
    t_rows = flight.ring_rows(*_rows(tend.flight))
    j_rows = jflight.ring_rows(np.asarray(jend.flight.rows),
                               int(jend.flight.count))
    assert len(t_rows) == len(j_rows) == 2
    assert [r["dt_used"] for r in t_rows] == [r["dt_used"] for r in j_rows]
    recs = [json.loads(line) for line in open(metrics)]
    assert [r["accepted"] for r in recs] == [False, False]
    assert [r["flight"]["dt_used"] for r in recs] == [r["dt_used"]
                                                      for r in t_rows]


def _arc_states(system_make, n_members, make_group, dtype_kw):
    """Members of 4 arcs of 8 nodes (curved: the strain is not noise)."""
    out = []
    for seed in range(n_members):
        rng = np.random.default_rng(seed + 1)
        origins = rng.uniform(-2, 2, (4, 3))
        d = rng.normal(size=(4, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = np.cross(d, rng.normal(size=(4, 3)))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        t = np.linspace(0, 1, 8)[None, :, None]
        x = (origins[:, None] + 2 * np.sin(t / 2) * d[:, None]
             + 2 * (1 - np.cos(t / 2)) * p[:, None])
        out.append(system_make(make_group(x, lengths=1.0,
                                          bending_rigidity=0.01,
                                          radius=0.0125, **dtype_kw)))
    return out


def _ensemble(batch_impl):
    """Three armed members (window 3), member 0 poisoned after two rounds,
    through the port's scheduler; (records, scheduler)."""
    from skellysim_tpu_torch.ensemble import (EnsembleRunner,
                                              EnsembleScheduler, MemberSpec)
    from skellysim_tpu_torch.fibers import container as tfc
    from skellysim_tpu_torch.guard import chaos
    from skellysim_tpu_torch.system import BackgroundFlow

    ts = port_system(fixtures.make_system(flight_window=3))
    bg = BackgroundFlow.make(uniform=(1.0, 0.0, 0.0), dtype=torch.float64,
                             device="cpu")
    states = _arc_states(lambda g: ts.make_state(fibers=g, background=bg), 3,
                         tfc.make_group, dict(dtype=torch.float64,
                                              device="cpu"))
    records = []
    sched = EnsembleScheduler(
        EnsembleRunner(ts, batch_impl=batch_impl),
        [MemberSpec(f"m{i}", s, 6e-3) for i, s in enumerate(states)], 3,
        metrics=records.append, on_failure="retire")
    sched.poll()
    sched.poll()
    sched.ens = chaos.poison_lane(sched.ens, 0)
    sched.run()
    return records


def _jax_ensemble():
    from skellysim_tpu.ensemble.runner import EnsembleRunner
    from skellysim_tpu.ensemble.scheduler import (EnsembleScheduler,
                                                  MemberSpec)
    from skellysim_tpu.fibers import container as jfc
    from skellysim_tpu.guard import chaos
    from skellysim_tpu.system import BackgroundFlow

    js = fixtures.make_system(flight_window=3)
    bg = BackgroundFlow.make(uniform=(1.0, 0.0, 0.0), dtype=jnp.float64)
    states = _arc_states(lambda g: js.make_state(fibers=g, background=bg), 3,
                         jfc.make_group, {})
    records = []
    sched = EnsembleScheduler(
        EnsembleRunner(js),
        [MemberSpec(f"m{i}", s, 6e-3) for i, s in enumerate(states)], 3,
        metrics=records.append, on_failure="retire")
    sched.poll()
    sched.poll()
    sched.ens = chaos.poison_lane(sched.ens, 0)
    sched.run()
    return records


def _by_member(records, event):
    out = {}
    for r in records:
        if r.get("event") == event:
            out.setdefault(r["member"], []).append(r)
    return out


def test_ensemble_lanes_record_per_member():
    vmap, unroll, jax_ = (_ensemble("vmap"), _ensemble("unroll"),
                          _jax_ensemble())
    steps_v, steps_u = _by_member(vmap, "step"), _by_member(unroll, "step")
    assert set(steps_v) == set(steps_u) == {"m0", "m1", "m2"}
    for m in steps_v:
        assert len(steps_v[m]) == len(steps_u[m])
        for a, b in zip(steps_v[m], steps_u[m]):
            fa, fb = a["flight"], b["flight"]
            for k in ("strain_fiber", "health", "prov_field", "prov_fiber",
                      "prov_node", "t"):
                assert fa[k] == fb[k], (m, k, fa, fb)
            for k in ("max_strain", "max_speed", "solution_norm"):
                assert fa[k] == pytest.approx(fb[k], rel=1e-6)
    # the healthy lanes carry no provenance; the poisoned one's failure
    # record names its offender, as JAX's does
    for m in ("m1", "m2"):
        assert all(r["flight"]["provenance"] is None for r in steps_v[m])
    for recs in (vmap, unroll):
        fails = _by_member(recs, "failed")
        j_fail = _by_member(jax_, "failed")["m0"][0]["flight"]
        assert list(fails) == ["m0"]
        payload = fails["m0"][0]["flight"]
        assert payload["provenance"] == j_fail["provenance"] == {
            "field": "fiber_x", "fiber": 0, "node": 0}
        assert [r["t"] for r in payload["tail"]] == [
            r["t"] for r in j_fail["tail"]]
        assert payload["tail"][-1]["health"] & 1


def test_four_shards_write_the_same_ring():
    from skellysim_tpu_torch.parallel import make_mesh, shard_state
    from skellysim_tpu_torch.parallel.mesh import gather_state

    js = fixtures.make_system(shell=True, flight_window=4)
    j0 = fixtures.coupled_state(js)
    ts = port_system(js)
    t0 = ts.ensure_flight(port_state(j0))
    mesh = make_mesh(4, device="cpu")
    new, _, info = ts.step_spmd(shard_state(t0, mesh), mesh)
    rings = [st.flight for st in new.shards]
    for r in rings[1:]:
        # bit for bit (the unwritten rows are NaN)
        assert torch.equal(r.rows.view(torch.int32),
                           rings[0].rows.view(torch.int32))
        assert torch.equal(r.count, rings[0].count)
    one, _, info1 = ts.step(t0)
    _same_row(rings[0].rows[0].numpy(), one.flight.rows[0].numpy())
    row = flight.last_row(*_rows(rings[0]))
    assert row["body_norm"] > 0 and row["health"] == 0
    assert gather_state(new).flight is new.shards[0].flight


def test_record_step_reads_nothing_back(coupled, monkeypatch):
    """No host read inside `record_step`: `Tensor.item` / `__bool__` /
    `tolist` raise while it runs."""
    jn, tn, tx, ti = coupled["steps"][0][:4]
    t0 = coupled["t0"]

    def boom(*a, **k):
        raise AssertionError("record_step read a device value on the host")

    for name in ("item", "__bool__", "tolist", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    ring = flight.record_step(t0, tn, tx, residual_true=ti.residual_true,
                              health=ti.health, dt_used=ti.dt_used,
                              shell_shape=coupled["ts"].shell_shape)
    monkeypatch.undo()
    assert int(ring.count) == int(tn.flight.count) + 1


def test_report_of_a_metrics_file_is_jax_text(tmp_path):
    """A port run's metrics file (one healthy trial, then a poisoned one)
    renders to the JAX package's report text."""
    over = dict(flight_window=4, t_final=1.0)
    ts = port_system(fixtures.make_system(**over))
    s0 = ts.ensure_flight(port_state(fixtures.free_state(
        fixtures.make_system(**over))))
    metrics = str(tmp_path / "run.jsonl")
    s1 = ts.run(s0, max_steps=1, metrics_path=metrics)
    from skellysim_tpu_torch.guard import chaos

    ts.run(chaos.poison_state(s1), max_steps=1, metrics_path=metrics)
    text = flight.render_flight_report([metrics])
    assert text == jflight.render_flight_report([metrics])
    assert "run: 2 step(s)" in text


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid", "generic"])
def test_signed_clearance_matches_jax(kind):
    """`periphery.signed_clearance` (the recorder's min_clearance) against
    the JAX package's for points inside and outside each wall."""
    from skellysim_tpu.periphery import periphery as jperi
    from skellysim_tpu_torch.periphery import periphery as tperi

    kw = {"sphere": dict(radius=2.0), "ellipsoid": dict(abc=(3.0, 2.0, 1.5)),
          "generic": {}}[kind]
    pts = np.random.default_rng(4).uniform(-4, 4, (200, 3))
    got = tperi.signed_clearance(tperi.PeripheryShape(kind=kind, **kw),
                                 torch.as_tensor(pts))
    ref = np.asarray(jperi.signed_clearance(
        jperi.PeripheryShape(kind=kind, **kw), jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-14)
    if kind != "generic":
        assert (ref < 0).any() and (ref > 0).any()
