"""The port's simulation service against the JAX package's.

Tenants are the JAX serve tests' scenes (`tests/test_serve.py`'s
`_tenant_cfg` and `_di_cfg`), in f64 on the CPU. Two ``"unroll"`` tenants
stream the bits of the port's sequential `System.run` and frames within
1e-10 of the JAX package's sequential `System.run`, with zero compile
events after warm-up; a snapshot, eviction and resume gives the same bits;
rejections carry the JAX package's messages (its
`tenants.parse_tenant_config` / `check_params_contract` are the oracle);
`/stats` has the JAX server's keys and counts for the same request
sequence, and its telemetry events (lane churn, rounds, drains) the JAX
server's; each package's `journal.replay` reads the other server's
journal, a torn tail loses only its frame, and a restarted server finishes
its tenants with the unkilled run's bits; a DI tenant reseats onto the
next bucket; a NaN tenant fails while its sibling streams its sequential
bits; garbled and oversized frames answer errors; a spawned server and the
chaos smoke run end to end on the CPU.
"""

import json
import os

import numpy as np
import pytest

from skellysim_tpu import config as jconfig
from skellysim_tpu.builder import build_simulation as jbuild
from skellysim_tpu.config import schema as jschema
from skellysim_tpu.config.toml_io import dumps as jdumps
from skellysim_tpu.io.trajectory import frame_bytes as jframe_bytes
from skellysim_tpu.serve import journal as jjournal
from skellysim_tpu.serve import protocol as jprotocol
from skellysim_tpu.serve import tenants as jtenants
from skellysim_tpu.serve.server import SimulationServer as JServer
from skellysim_tpu_torch import config as tconfig
from skellysim_tpu_torch.builder import build_simulation as tbuild
from skellysim_tpu_torch.config import schema as tschema
from skellysim_tpu_torch.config.toml_io import dumps as tdumps
from skellysim_tpu_torch.guard import chaos
from skellysim_tpu_torch.guard import verdict
from skellysim_tpu_torch.io.trajectory import frame_bytes
from skellysim_tpu_torch.serve import journal as tjournal
from skellysim_tpu_torch.serve import protocol
from skellysim_tpu_torch.serve import tenants as ttenants
from skellysim_tpu_torch.serve.server import SimulationServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: frames of the port against the JAX package's
TOL = 1e-10


def _tenant_cfg(mod, shift=0.0, n_nodes=8, n_fibers=1, **params):
    """`tests/test_serve.py::_tenant_cfg` in either package's schema."""
    cfg = mod.Config()
    p = cfg.params
    p.eta, p.dt_initial, p.dt_write, p.t_final = 1.0, 0.005, 0.005, 0.02
    p.gmres_tol, p.adaptive_timestep_flag = 1e-10, False
    for k, v in params.items():
        setattr(p, k, v)
    fibers = []
    for i in range(n_fibers):
        fib = mod.Fiber(n_nodes=n_nodes, length=1.0, bending_rigidity=0.01)
        fib.fill_node_positions(np.array([shift + 0.4 * i, 0.0, 0.0]),
                                np.array([0.0, 0.0, 1.0]))
        fibers.append(fib)
    cfg.fibers = fibers
    cfg.background = mod.BackgroundSource(uniform=[1.0, 0.0, 0.0])
    return cfg


def _cfg(shift=0.0, **kw):
    return _tenant_cfg(tconfig, shift, **kw)


def _toml(cfg) -> str:
    return tdumps(tschema.unpack(cfg))


def _seq_frames(cfg) -> list:
    """The port's sequential trajectory: the initial frame and the
    `System.run` boundary frames, stamped with the RNG state."""
    system, state, rng = tbuild(cfg, device="cpu")
    rs = rng.dump_state()
    frames = [frame_bytes(state, rng_state=rs)]
    system.run(state, writer=lambda st, sol, **kw: frames.append(
        frame_bytes(st, rng_state=rs)))
    return frames


def _jax_seq_frames(cfgs) -> list:
    """The JAX package's sequential trajectories of ``cfgs`` (scenes of one
    shape and params: one system runs them all, one compile)."""
    system = jbuild(cfgs[0])[0]
    out = []
    for cfg in cfgs:
        _, state, rng = jbuild(cfg)
        rs = rng.dump_state()
        frames = [jframe_bytes(state, rng_state=rs)]
        system.run(state, writer=lambda st, sol, **kw: frames.append(
            jframe_bytes(st, rng_state=rs)))
        out.append(frames)
    return out


def _close(a, b, where="frame"):
    """Decoded frames equal in structure; floats within TOL of each other
    relative to their magnitude, the rest exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, float)):
        a, b = np.asarray(a, float), np.asarray(b, float)
        assert a.shape == b.shape, where
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        assert np.abs(a - b).max(initial=0.0) <= TOL * scale, where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def server():
    """One warm 2-lane "unroll" port server shared by the module (tenant
    records accumulate; each test takes fresh tenants)."""
    return SimulationServer(
        _cfg(), serve_cfg=tschema.ServeConfig(max_lanes=2,
                                              batch_impl="unroll"),
        device="cpu")


def _submit(srv, cfg, **fields):
    resp = srv.handle_request({"type": "submit", "config": _toml(cfg),
                               **fields})
    assert resp["ok"], resp.get("error")
    return resp


def _drain(srv, max_rounds=200):
    n = 0
    while srv.any_live() and n < max_rounds:
        srv.tick()
        n += 1
    assert not srv.any_live(), "service did not drain"


def _stream(srv, tenant) -> list:
    resp = srv.handle_request({"type": "stream", "tenant": tenant})
    assert resp["ok"]
    return [bytes(f) for f in resp["frames"]]


# ---------------------------------------------------- the acceptance pins

def test_two_tenants_bits_and_jax_frames_zero_compiles_after_warm(server):
    """Two concurrent "unroll" tenants in one bucket stream the bits of
    the port's sequential runs and frames within 1e-10 of the JAX
    package's; no CUDA library loads after warm-up."""
    assert server.metrics.warm and server.warmup_s
    shifts = (0.1, 0.3)
    resp = [_submit(server, _cfg(s)) for s in shifts]
    assert [r["lane"] for r in resp] == [0, 1]
    assert len({r["bucket"] for r in resp}) == 1
    _drain(server)
    refs = _jax_seq_frames([_tenant_cfg(jconfig, s) for s in shifts])
    for r, s, ref in zip(resp, shifts, refs):
        got = _stream(server, r["tenant"])
        assert len(got) >= 3
        assert got == _seq_frames(_cfg(s))
        assert len(ref) == len(got)
        for g, j in zip(got, ref):
            _close(protocol.unpack_message(g),
                   jprotocol.unpack_message(j))
        st = server.handle_request({"type": "status", "tenant": r["tenant"]})
        assert st["status"] == "finished" and st["t"] <= st["t_final"]
    assert server.metrics.stats()["compiles_after_warm"] == 0


def test_snapshot_evict_resume_same_bits(server):
    """Evict a tenant mid-service and re-admit it from its snapshot: the
    frames before and after are the uninterrupted run's bits."""
    cfg = _cfg(0.7)
    r = _submit(server, cfg)
    server.tick()
    server.tick()
    snap = server.handle_request({"type": "snapshot", "tenant": r["tenant"]})
    assert snap["ok"] and snap["status"] == "running"
    server.handle_request({"type": "cancel", "tenant": r["tenant"]})
    pre = _stream(server, r["tenant"])
    assert server.handle_request(
        {"type": "status", "tenant": r["tenant"]})["status"] == "cancelled"
    r2 = server.handle_request({"type": "submit", "config": _toml(cfg),
                                "resume_frame": bytes(snap["frame"])})
    assert r2["ok"], r2.get("error")
    _drain(server)
    assert pre + _stream(server, r2["tenant"]) == _seq_frames(cfg)
    assert server.metrics.stats()["compiles_after_warm"] == 0


def test_disconnect_evicts_and_snapshot_survives(server):
    conn = object()
    r = _submit(server, _cfg(0.9))
    server.registry.get(r["tenant"]).conn = conn
    server.tick()
    server.evict_conn(conn)
    st = server.handle_request({"type": "status", "tenant": r["tenant"]})
    assert st["status"] == "evicted" and st["lane"] is None
    snap = server.handle_request({"type": "snapshot", "tenant": r["tenant"]})
    assert snap["ok"] and snap["t"] > 0.0
    assert not server.any_live()


# ------------------------------------------------------------- rejections

def _jax_contract(cfg_port, cfg_jax):
    """The JAX oracle's text for a params-contract rejection."""
    base = _tenant_cfg(jconfig)
    return jtenants.check_params_contract(cfg_jax.params, base.params)


@pytest.mark.parametrize("case", ["params_contract", "parse_error",
                                  "no_fibers", "bodies_on_plain",
                                  "periphery"])
def test_config_rejections_carry_jax_messages(server, case):
    """The port server's error text is the JAX package's for the same
    submitted TOML (its parse_tenant_config / check_params_contract)."""
    if case == "params_contract":
        text = _toml(_cfg(gmres_tol=1e-6))
        want = jtenants.check_params_contract(
            _tenant_cfg(jconfig, gmres_tol=1e-6).params,
            _tenant_cfg(jconfig).params)
    else:
        if case == "parse_error":
            text = "not toml ["
        elif case == "no_fibers":
            text = "[params]\nt_final = 0.02\n"
        elif case == "bodies_on_plain":
            cfg = _cfg()
            cfg.bodies = [tconfig.Body(shape="sphere", radius=0.4,
                                       n_nodes=40)]
            text = _toml(cfg)
        else:
            cfg = tconfig.ConfigSpherical()
            cfg.fibers = _cfg().fibers
            text = _toml(cfg)
        with pytest.raises(ValueError) as e:
            jtenants.parse_tenant_config(text, di_enabled=False)
        want = str(e.value)
        with pytest.raises(ValueError) as e:
            ttenants.parse_tenant_config(text, di_enabled=False)
        assert str(e.value) == want
    rejected = server.metrics.rejected
    resp = server.handle_request({"type": "submit", "config": text})
    assert not resp["ok"] and resp["error"] == want
    assert server.metrics.rejected == rejected + 1


@pytest.mark.parametrize("shape", [dict(n_nodes=16), dict(n_fibers=3)])
def test_bucket_mismatch_rejection(server, shape):
    """A scene that fits no bucket answers the structured rejection with
    the nearest bucket, as the JAX server does."""
    resp = server.handle_request({"type": "submit",
                                  "config": _toml(_cfg(**shape))})
    assert not resp["ok"]
    assert resp["error"].startswith("no capacity bucket matches this scene")
    assert resp["nearest_bucket"]["capacity"] == 1
    assert resp["nearest_bucket"]["fibers"] == [[1, 8]]


def test_queue_sheds_cancel_and_unknown_tenant(server):
    """Lanes full -> queue; queue full -> retry=True; a cancelled queued
    tenant keeps its admitted state as the snapshot; an unknown tenant and
    a malformed request answer the JAX package's errors."""
    rs = [_submit(server, _cfg(0.05 * i)) for i in range(3)]
    assert rs[2]["queued"] and rs[2]["lane"] is None
    depth = server.serve_cfg.queue_depth
    server.serve_cfg.queue_depth = 1
    try:
        resp = server.handle_request({"type": "submit",
                                      "config": _toml(_cfg(0.9))})
        assert not resp["ok"] and resp.get("retry") is True
        assert resp["error"].startswith("admission queue full")
    finally:
        server.serve_cfg.queue_depth = depth
    resp = server.handle_request({"type": "cancel",
                                  "tenant": rs[2]["tenant"]})
    assert resp["ok"] and resp["status"] == "cancelled"
    snap = server.handle_request({"type": "snapshot",
                                  "tenant": rs[2]["tenant"]})
    assert snap["ok"] and snap["t"] == 0.0
    _drain(server)
    assert [server.handle_request({"type": "status", "tenant": r["tenant"]})
            ["status"] for r in rs] == ["finished", "finished", "cancelled"]
    assert server.handle_request({"type": "status", "tenant": "nope"}
                                 )["error"] == "unknown tenant 'nope'"
    assert server.handle_request({"type": "gibberish"})["error"] == \
        jprotocol.validate_request({"type": "gibberish"})


def test_explicit_zero_t_final_and_record_ttl(server):
    r = _submit(server, _cfg(0.55), t_final=0.0)
    _drain(server)
    tid = r["tenant"]
    st = server.handle_request({"type": "status", "tenant": tid})
    assert st["status"] == "finished" and st["steps"] == 0
    old = server.serve_cfg.record_ttl_s
    try:
        server.serve_cfg.record_ttl_s = 60.0
        server.tick()
        assert server.handle_request({"type": "status", "tenant": tid})["ok"]
        server.registry.get(tid).retired_at -= 120.0
        resp = server.handle_request({"type": "status", "tenant": tid})
        assert not resp["ok"] and "unknown tenant" in resp["error"]
    finally:
        server.serve_cfg.record_ttl_s = old


def test_serve_config_loading_matches_jax(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text("[serve]\nmax_lanes = 3\nbucket_capacities = [2, 4]\n"
                 "queue_depth = 5\n")
    assert tschema.load_serve_config(str(p)) == \
        tschema.ServeConfig(**vars(jschema.load_serve_config(str(p))))
    for bad in ("[serve]\nmax_lens = 3\n", "[serve]\nbatch_impl = 'nope'\n",
                "[serve]\njournal_path = 'j'\njournal_every = 0\n"):
        p.write_text(bad)
        with pytest.raises(ValueError) as j:
            jschema.load_serve_config(str(p))
        with pytest.raises(ValueError) as t:
            tschema.load_serve_config(str(p))
        assert str(t.value) == str(j.value)


# -------------------------------------------- /stats and journals, JAX side

def _sequence(srv, mod, toml):
    """The same request sequence on either package's server: three
    tenants through two lanes (one queued, backfilled), one rejection,
    every stream drained."""
    ids = []
    for s in (0.1, 0.3, 0.5):
        r = srv.handle_request({"type": "submit",
                                "config": toml(_tenant_cfg(mod, s))})
        assert r["ok"], r
        ids.append(r["tenant"])
    bad = srv.handle_request({"type": "submit",
                              "config": toml(_tenant_cfg(mod, gmres_tol=1e-6))})
    assert not bad["ok"]
    n = 0
    while srv.any_live() and n < 200:
        srv.tick()
        n += 1
    frames = {t: srv.handle_request({"type": "stream", "tenant": t})
              ["frames"] for t in ids}
    return ids, frames, srv.handle_request({"type": "stats"})["stats"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port server, journaling, through the same sequence."""
    d = tmp_path_factory.mktemp("pair")
    out = {}
    for tag, srv_cls, mod, toml, kw in (
            ("jax", JServer, jconfig,
             lambda c: jdumps(jschema.unpack(c)), {}),
            ("port", SimulationServer, tconfig, _toml,
             {"device": "cpu"})):
        path = str(d / f"{tag}.wal")
        scfg = (jschema if tag == "jax" else tschema).ServeConfig(
            max_lanes=2, batch_impl="unroll", journal_path=path,
            journal_every=2)
        srv = srv_cls(_tenant_cfg(mod), serve_cfg=scfg, **kw)
        out[tag] = (srv, path) + _sequence(srv, mod, toml)
        srv.journal.close()
    return out


def test_stats_keys_and_counts_match_jax(pair):
    """The same keys and counts as the JAX server's `/stats` (the
    compile count aside: JAX counts its XLA compiles, the port its CUDA
    libraries, none on the CPU)."""
    _, _, _, _, j = pair["jax"]
    _, _, _, _, t = pair["port"]
    assert set(t) == set(j)
    for key in ("admitted", "rejected", "retired", "retire_reasons",
                "rounds", "steps", "mean_occupancy", "compiles_after_warm",
                "warm", "faults", "fault_fields", "loss_of_accuracy_steps",
                "growth_reseats", "frames_streamed", "frames_streamed_total",
                "tenants", "journal", "buckets"):
        assert t[key] == j[key], key
    for key in ("admission_wait_s", "round_wall_s_hist", "frame_stream_s"):
        assert set(t[key]) == set(j[key])
        assert t[key]["n"] == j[key]["n"], key
        assert t[key]["p50"] <= t[key]["p95"] <= t[key]["p99"]
    assert set(t["histograms"]) == set(j["histograms"])
    assert t["compiles"] == 0 and j["compiles"] >= 1
    text = protocol.render_prometheus(t)
    for line in text.strip().splitlines():
        assert line.startswith("#") or len(line.split()) == 2, line


def test_server_events_match_jax(pair):
    """The servers' telemetry for the same requests: lane admit /
    backfill / retire events, one ``ensemble_step`` span a round (round,
    live, lanes) and the ``stream_frames`` spans, in the JAX server's
    order with its fields, clocks and the JAX package's XLA ``compile``
    events aside."""
    from test_torch_tracer import _shape

    j = _shape(pair["jax"][0].tracer.events)
    t = _shape(pair["port"][0].tracer.events)
    assert [e["ev"] for e in t] == [e["ev"] for e in j]
    assert {e.get("action") for e in t if e["ev"] == "lane"} == \
        {"admit", "backfill", "retire"}
    for a, b in zip(j, t):
        assert set(a) == set(b), (a, b)
        if a["ev"] in ("lane", "span"):
            assert a == b, (a, b)


def test_streams_match_jax_frames(pair):
    _, _, jids, jframes, _ = pair["jax"]
    _, _, tids, tframes, _ = pair["port"]
    for jt, tt in zip(jids, tids):
        assert len(tframes[tt]) == len(jframes[jt]) >= 3
        for g, r in zip(tframes[tt], jframes[jt]):
            _close(protocol.unpack_message(bytes(g)),
                   jprotocol.unpack_message(bytes(r)))


def test_each_package_replays_the_others_journal(pair):
    """The port's `journal.replay` reads the JAX server's journal and the
    JAX package's reads the port server's: the same tenants, kinds,
    statuses and times, and final frames within 1e-10."""
    jpath, tpath = pair["jax"][1], pair["port"][1]
    for path in (jpath, tpath):
        assert tjournal.replay(path).keys() == jjournal.replay(path).keys()
    a, b = tjournal.replay(jpath), jjournal.replay(tpath)
    assert sorted(a) == sorted(b) and len(a) == 3
    for tid in a:
        x, y = a[tid], b[tid]
        assert {k: x[k] for k in ("kind", "status", "bucket", "t_final",
                                  "health")} == \
            {k: y[k] for k in ("kind", "status", "bucket", "t_final",
                               "health")}
        assert abs(x["t"] - y["t"]) <= 1e-12
        _close(protocol.unpack_message(bytes(x["frame"])),
               jprotocol.unpack_message(bytes(y["frame"])))


def test_journal_torn_tail(tmp_path):
    p = tmp_path / "j.bin"
    with tjournal.TenantJournal(str(p)) as j:
        j.record("admit", "tA", bucket=1, t_final=0.5, status="queued",
                 frame=b"F0")
        j.record("checkpoint", "tA", bucket=1, t_final=0.5,
                 status="running", frame=b"F1", t=0.25)
        j.record("admit", "tB", bucket=1, t_final=0.5, status="queued",
                 frame=b"G0")
        j.record("retire", "tB", bucket=1, t_final=0.5, status="finished",
                 t=0.5, health=0)
    entries = tjournal.replay(str(p))
    assert entries["tA"]["status"] == "running"
    assert bytes(entries["tA"]["frame"]) == b"F1"
    assert bytes(entries["tB"]["frame"]) == b"G0"
    assert entries == jjournal.replay(str(p))
    p.write_bytes(p.read_bytes()[:-3])
    torn = tjournal.replay(str(p))
    assert torn["tA"]["status"] == "running"
    assert torn["tB"]["status"] == "queued"
    assert torn == jjournal.replay(str(p))
    assert tjournal.replay(str(tmp_path / "missing.bin")) == {}


def _entry_count(path) -> int:
    n = 0
    with open(path, "rb") as fh:
        while True:
            try:
                buf = protocol.read_frame(fh)
            except ValueError:
                break
            if not buf:
                break
            n += 1
    return n


def test_journal_recovery_evicts_unreadmittable_live_records(tmp_path):
    wal = tmp_path / "wal.bin"
    with tjournal.TenantJournal(str(wal)) as j:
        j.record("checkpoint", "ghost", bucket=999, t_final=1.0,
                 status="running", frame=b"not-a-real-frame", t=0.5)
        j.record("checkpoint", "junk", bucket=1, t_final=1.0,
                 status="running", frame=b"also-not-a-frame", t=0.5)
    srv = SimulationServer(
        _cfg(), warmup=False, device="cpu",
        serve_cfg=tschema.ServeConfig(max_lanes=2, batch_impl="unroll",
                                      journal_path=str(wal)))
    for tid in ("ghost", "junk"):
        st = srv.handle_request({"type": "status", "tenant": tid})
        assert st["ok"] and st["status"] == "evicted", (tid, st)
    assert not srv.any_live()
    assert _entry_count(str(wal)) == 2
    srv.journal.close()


def test_journal_crash_recovery_matches_unkilled_run(tmp_path):
    """Abandon a journaling server mid-flight, restart on its journal:
    the re-admitted tenant finishes with the unkilled run's final bits,
    the journal compacted to one entry a tenant."""
    cfg = _cfg(0.35)
    scfg = tschema.ServeConfig(max_lanes=2, batch_impl="unroll",
                               journal_path=str(tmp_path / "wal.bin"),
                               journal_every=2)
    srv = SimulationServer(cfg, serve_cfg=scfg, device="cpu")
    tid = _submit(srv, cfg)["tenant"]
    _submit(srv, _cfg(0.05))
    for _ in range(3):
        srv.tick()
    st = srv.handle_request({"type": "status", "tenant": tid})
    assert st["status"] == "running" and 0.0 < st["t"] < st["t_final"]
    srv.journal.close()
    srv2 = SimulationServer(cfg, serve_cfg=scfg, device="cpu")
    assert _entry_count(scfg.journal_path) == 2
    st2 = srv2.handle_request({"type": "status", "tenant": tid})
    assert st2["status"] in ("queued", "running") and st2["t"] <= st["t"]
    _drain(srv2)
    snap = srv2.handle_request({"type": "snapshot", "tenant": tid})
    assert srv2.handle_request({"type": "status", "tenant": tid}
                               )["status"] == "finished"
    assert bytes(snap["frame"]) == _seq_frames(cfg)[-1]
    assert srv2.handle_request({"type": "stats"})["stats"]["journal"]
    srv2.journal.close()


# --------------------------------------------- DI, quarantine, the wire

def _di_cfg(mod, n_sites=4, nucleation_rate=200.0, t_final=0.04,
            seed=130319):
    """`tests/test_serve.py::_di_cfg` in either package's schema."""
    cfg = mod.Config()
    p = cfg.params
    p.eta, p.dt_initial, p.dt_write, p.t_final = 1.0, 0.02, 0.02, t_final
    p.gmres_tol, p.adaptive_timestep_flag, p.seed = 1e-10, False, seed
    di = p.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = 8, 0.2, 0.0
    di.nucleation_rate, di.min_length = nucleation_rate, 0.3
    di.radius, di.bending_rigidity = 0.0125, 0.01
    rng = np.random.default_rng(7)
    sites = rng.standard_normal((n_sites, 3))
    sites = 0.4 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
    cfg.bodies = [mod.Body(shape="sphere", radius=0.4, n_nodes=40,
                           n_nucleation_sites=n_sites,
                           nucleation_sites=sites.ravel().tolist())]
    return cfg


def test_di_tenant_admission_rules_match_jax():
    text = _toml(_di_cfg(tconfig))
    for di_enabled in (False, True):
        try:
            jtenants.parse_tenant_config(text, di_enabled=di_enabled)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            ttenants.parse_tenant_config(text, di_enabled=di_enabled)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want
    bad = _di_cfg(tconfig)
    bad.bodies[0].nucleation_sites = []
    with pytest.raises(ValueError, match="embed"):
        ttenants.parse_tenant_config(_toml(bad), di_enabled=True)


def test_di_tenant_growth_reseat_and_finish():
    """A fiber-less DI tenant whose first nucleations outgrow the 2-slot
    bucket reseats onto the 4-slot one and finishes with a streamable
    trajectory; every frame's fibers are the step's active ones."""
    srv = SimulationServer(
        _di_cfg(tconfig), device="cpu",
        serve_cfg=tschema.ServeConfig(max_lanes=1, batch_impl="vmap",
                                      bucket_capacities=[2, 4]))
    assert srv.di_enabled and [b.capacity for b in srv.buckets] == [2, 4]
    r = _submit(srv, _di_cfg(tconfig, seed=7), tenant="di0")
    assert r["tenant"] == "di0"
    _drain(srv)
    st = srv.handle_request({"type": "status", "tenant": "di0"})
    assert st["status"] == "finished", st
    stats = srv.handle_request({"type": "stats"})["stats"]
    assert stats["growth_reseats"] >= 1
    assert srv.registry.get("di0").bucket == 4
    frames = [protocol.unpack_message(f) for f in _stream(srv, "di0")]
    assert len(frames) >= 2 and frames[-1]["rng_state"]
    assert all(np.isfinite(np.asarray(f["x_"])).all()
               for fr in frames for f in fr["fibers"][1])
    assert len(frames[-1]["fibers"][1]) > 0
    lanes = [e for e in srv.tracer.events if e["ev"] == "lane"]
    assert "growth" in [e["action"] for e in lanes]


def test_nan_tenant_fails_sibling_streams_its_bits(server):
    """A NaN in tenant A's lane: A answers failed with the nonfinite
    verdict and a terminal stream; its sibling finishes with the bits of
    its sequential run."""
    ra = _submit(server, _cfg(0.25))
    rb = _submit(server, _cfg(0.45))
    server.tick()
    chaos.nan_lane_of(server.buckets[0].scheduler, ra["tenant"])
    _drain(server)
    sa = server.handle_request({"type": "status", "tenant": ra["tenant"]})
    assert sa["status"] == "failed" and sa["health"] & verdict.NONFINITE
    assert "nonfinite" in sa["verdict"]
    sb = server.handle_request({"type": "status", "tenant": rb["tenant"]})
    assert sb["status"] == "finished" and sb["health"] == 0
    resp = server.handle_request({"type": "stream", "tenant": ra["tenant"]})
    assert resp["ok"] and resp["eof"] is True
    assert _stream(server, rb["tenant"]) == _seq_frames(_cfg(0.45))
    stats = server.metrics.stats()
    assert stats["faults"].get("lane_failed", 0) >= 1
    assert stats["compiles_after_warm"] == 0


class _StubConn:
    def __init__(self, data: bytes):
        self._data, self.sent = data, b""

    def recv(self, n):
        d, self._data = self._data, b""
        return d

    def sendall(self, b):
        self.sent += b

    def close(self):
        pass


class _StubSel:
    def unregister(self, c):
        pass


@pytest.mark.parametrize("wire", ["garbled", "oversized", "truncated"])
def test_server_survives_corrupt_frames(server, wire):
    """A garbled request answers "undecodable", an oversized header an
    error flagged ``oversized`` (its declared bytes then skipped), a
    truncated frame nothing yet; the connection survives, and after a
    garbled or truncated frame serves the next valid request."""
    valid = protocol.pack_message({"type": "stats"})
    framed = protocol.HEADER.pack(len(valid)) + valid
    data = {"garbled": lambda: (lambda g: protocol.HEADER.pack(len(g)) + g)(
                chaos.garble_frame(valid, seed=1)),
            "oversized": lambda: chaos.oversized_header(1 << 40),
            "truncated": lambda: chaos.truncate_frame(framed, 5)}[wire]()
    conn = _StubConn(data)
    decoders = {conn: protocol.FrameDecoder()}
    server._service_conn(conn, decoders, _StubSel())
    resps = [protocol.unpack_message(f)
             for f in protocol.FrameDecoder().feed(conn.sent)]
    if wire == "truncated":
        assert resps == []
    else:
        assert resps and resps[0]["ok"] is False
        assert ("undecodable" in resps[0]["error"] if wire == "garbled"
                else resps[0].get("oversized") is True)
    assert conn in decoders
    if wire == "oversized":
        # the decoder skips the declared bytes; nothing more to serve
        assert decoders[conn].oversized == 1
        return
    conn._data = framed[5:] if wire == "truncated" else framed
    server._service_conn(conn, decoders, _StubSel())
    last = protocol.FrameDecoder().feed(conn.sent)[-1]
    assert protocol.unpack_message(last)["ok"] is True


def test_chaos_request_gated_off_by_default(server):
    resp = server.handle_request({"type": "chaos", "action": "nan_lane",
                                  "tenant": "whatever"})
    assert resp["ok"] is False and "chaos_enabled" in resp["error"]


def test_queue_wait_on_lane_events_and_summarize(server):
    """Admissions carry ``queue_wait_s``, a backfilled one a positive
    wait; `obs.summarize` renders the lanes table and the wait."""
    from skellysim_tpu_torch.obs.summarize import Summary

    for i in range(3):
        _submit(server, _cfg(0.2 * i))
    _drain(server)
    lane = [e for e in server.tracer.events if e["ev"] == "lane"
            and e["action"] in ("admit", "backfill")]
    assert lane and all(e["queue_wait_s"] >= 0.0 for e in lane)
    assert any(e["queue_wait_s"] > 0.0 for e in lane
               if e["action"] == "backfill")
    s = Summary()
    for e in server.tracer.events:
        s.add_line(json.dumps(e))
    report = s.render()
    assert "admission wait:" in report and "ensemble lanes" in report


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def test_spawned_server_end_to_end(tmp_path):
    """`python -m skellysim_tpu_torch.serve --device cpu` over TCP: two
    tenants finish and stream, /stats carries the percentiles and the
    Prometheus page, the server shuts down with exit code 0."""
    from skellysim_tpu_torch.serve.client import SpawnedServer

    cfg_path = str(tmp_path / "serve_config.toml")
    _cfg().save(cfg_path)
    with open(cfg_path, "a") as fh:
        fh.write('\n[serve]\nmax_lanes = 2\nbatch_impl = "unroll"\n')
    with SpawnedServer(cfg_path, args=["--device", "cpu"],
                       env=_env()) as srv:
        with srv.client() as c:
            tids = [c.submit(_toml(_cfg(s)))["tenant"] for s in (0.1, 0.3)]
            for tid in tids:
                assert c.wait(tid, timeout=120)["status"] == "finished"
                assert len(c.stream(tid)["frames"]) >= 2
            stats = c.stats()
            assert stats["compiles_after_warm"] == 0
            assert stats["admission_wait_s"]["n"] == stats["admitted"] == 2
            for key in ("admission_wait_s", "round_wall_s_hist",
                        "frame_stream_s"):
                slo = stats[key]
                assert slo["p50"] <= slo["p95"] <= slo["p99"]
            prom = c.stats_prometheus()
            assert "skellysim_serve_compiles_after_warm_total 0" in prom
        rc = srv.stop()
    assert rc == 0


def test_chaos_smoke_on_the_cpu(tmp_path):
    """`guard.smoke`: NaN quarantine with provenance, then SIGKILL and
    recovery from the journal, over spawned CPU servers."""
    from skellysim_tpu_torch.guard import smoke

    assert smoke.main(str(tmp_path), device="cpu") == 0
