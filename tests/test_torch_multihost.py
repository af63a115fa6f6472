"""The port over several processes (`parallel.multihost`) on the CPU.

The counterpart of `tests/test_multihost.py` (the JAX package's two
`jax.distributed` processes) and of the reference's 2-rank `mpiexec`
tier: real subprocesses (`tests/torch_multihost_worker.py`) join over
`gloo` at ``tcp://localhost:<free port>``, each holding its shards of one
4-shard mesh, and what they compute is held against the same case run in
one process. That one-process run is a subprocess too, started beside the
others with the same environment: MKL's blocked products give other last
bits under another thread count, and a process inherits its thread count
from its environment. With it, the multi-process ring and step give the
one-process bits exactly.

Every run has a deadline under a minute (`skellysim_tpu_torch.testing
.run_all`): a worker that fails stops the others at once, and a worker
stuck in a collective is killed at the deadline, so a hang fails in well
under a minute.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.parallel import make_mesh as jmake_mesh
from skellysim_tpu.parallel import shard_state as jshard_state
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch.config import Config, Fiber
from skellysim_tpu_torch.parallel import multihost
from skellysim_tpu_torch.testing import free_port, make_coupled_parts, run_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
#: seconds a run of processes may take before the test kills them
DEADLINE_S = 50
#: the reference's backend-agreement gate (`kernel_test.cpp:93`)
GATE = 5e-9


def _run_all(cmds, tmp_path, tag):
    """`run_all` with the test's deadline; a failure fails the test."""
    try:
        return run_all(cmds, tmp_path, tag, DEADLINE_S)
    except RuntimeError as e:
        pytest.fail(str(e))


def _case(case, world, tmp_path):
    """``case`` on 4 shards: in ``world`` processes and in one, side by
    side; returns (every process's record, the one-process record)."""
    import torch_multihost_worker as w

    port = free_port()
    spread, one = tmp_path / f"{case}_{world}", tmp_path / f"{case}_1"
    spread.mkdir()
    one.mkdir(exist_ok=True)
    cmds = [([sys.executable, WORKER, case, str(port), str(rank), str(world),
              str(spread)], w.worker_env(), REPO) for rank in range(world)]
    cmds.append(([sys.executable, WORKER, case, "0", "0", "1", str(one)],
                 w.worker_env(), REPO))
    outs = _run_all(cmds, tmp_path, f"{case}_{world}")
    for rank, out in enumerate(outs[:-1]):
        assert f"TORCH-MULTIHOST-OK {case} {rank}" in out, out

    def load(path):
        return torch.load(path, weights_only=False)

    return ([load(spread / f"{case}_{r}.pt") for r in range(world)],
            load(one / f"{case}_0.pt"))


def _same(a, b) -> bool:
    return torch.equal(a, b)


def test_initialize_one_process_is_a_noop(monkeypatch):
    """One process and no coordinator: `initialize` returns False and
    joins nothing; `process_info` gives the JAX module's four keys (the
    counterpart of `tests/test_shell_sharding.py`'s no-op test)."""
    for var in ("SKELLY_COORDINATOR", "SKELLY_NUM_PROCS", "SKELLY_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("SKELLY_NUM_PROCS", "1")
    assert multihost.initialize() is False
    assert multihost.runtime() is None
    info = multihost.process_info()
    assert set(info) == {"process_index", "process_count",
                         "local_device_count", "global_device_count"}
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_device_count"] >= 1
    from skellysim_tpu_torch.parallel import initialize_multihost, process_info

    assert initialize_multihost is multihost.initialize
    assert process_info is multihost.process_info


def test_initialize_needs_every_argument(monkeypatch):
    """A coordinator without a process count or index raises before any
    process group starts."""
    for var in ("SKELLY_NUM_PROCS", "SKELLY_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKELLY_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="SKELLY_NUM_PROCS"):
        multihost.initialize()
    assert multihost.runtime() is None


def test_initialize_without_a_card_raises(monkeypatch):
    """Where no card is visible, joining without ``device="cpu"`` raises
    before any process group starts: the default device is the card, as
    in the CLI, and the CPU is taken only where asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.initialize("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.initialize("localhost:1", 2, 0, device="cuda:1")
    assert multihost.runtime() is None


def test_fused_ring_mode_follows_the_layout(monkeypatch):
    """The fused ring needs every card driven by one process: two
    processes sharing a card take the hop-by-hop ring ("ppermute"), one
    process a card (or every shard in one process) the fused kernels;
    ``SKELLY_FUSED_RING=0`` and CPU tensors keep their meaning. The rule
    reads the mesh's layout alone: nothing here touches a card."""
    from skellysim_tpu_torch.parallel.compat import fused_ring_mode
    from skellysim_tpu_torch.parallel.mesh import Mesh

    monkeypatch.delenv("SKELLY_FUSED_RING", raising=False)
    cuda = [torch.device("cuda", k) for k in range(4)]
    shared = Mesh((cuda[0],) * 4, processes=(0, 0, 1, 1),
                  cards=("card0",) * 4, process=1)
    own = Mesh(tuple(cuda), processes=(0, 1, 2, 3),
               cards=tuple(f"card{k}" for k in range(4)), process=2)
    two_each = Mesh((cuda[0], cuda[0], cuda[1], cuda[1]),
                    processes=(0, 0, 1, 1),
                    cards=("card0", "card0", "card1", "card1"))
    assert shared.spans_processes and shared.shared_cards() == ["card0"]
    assert list(shared.local) == [2, 3] and list(own.local) == [2]
    assert fused_ring_mode("pallas", cuda[0], shared) == "ppermute"
    assert fused_ring_mode("pallas", cuda[0], shared) == "ppermute"
    for mesh in (own, two_each, Mesh((cuda[0],) * 4), None):
        assert fused_ring_mode("pallas", cuda[0], mesh) == "fused"
    assert fused_ring_mode("exact", cuda[0], own) == "ppermute"
    assert fused_ring_mode("pallas", torch.device("cpu"), own) == "ppermute"
    monkeypatch.setenv("SKELLY_FUSED_RING", "0")
    assert fused_ring_mode("pallas", cuda[0], own) == "ppermute"


def test_ring_across_two_processes(tmp_path):
    """The JAX worker's case: 2 processes x 2 shards, `ring_stokeslet` on
    the global 4-shard mesh (the hops between the processes by
    `batch_isend_irecv`), against its numpy dense oracle at 5e-9, and the
    one-process 4-shard ring bit for bit, in both processes."""
    import torch_multihost_worker as w

    recs, one = _case("ring", 2, tmp_path)
    r, f = w.ring_cloud()
    d = r[:, None, :] - r[None, :, :]
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, np.inf)
    rinv = 1.0 / np.sqrt(r2)
    df = np.einsum("tsk,sk->ts", d, f)
    ref = (np.einsum("ts,sk->tk", rinv, f)
           + np.einsum("ts,tsk->tk", df * rinv**3, d)) / (8 * np.pi * 1.3)
    for rec in recs:
        got = rec["u"].numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < GATE
        assert _same(rec["u"], one["u"])
    assert [rec["process"]["process_index"] for rec in recs] == [0, 1]


def _jax_coupled_step():
    """The JAX package's `step_spmd` of the coupled scene on 4 of
    conftest's virtual devices (as `test_torch_spmd.py` builds it)."""
    from skellysim_tpu.bodies.bodies import BodyGroup as JBodies

    import torch_multihost_worker as w

    shell, _, bodies = make_coupled_parts(56, 50)

    def jleaves(nt, cls):
        return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                      for k, v in nt._asdict().items()})

    jsys = JSystem(JParams(**w.PARAMS), shell_shape=jperi.PeripheryShape(
        **dataclasses.asdict(w.SHAPE)))
    fib = jfc.make_group(w.arcs(seed=7, box=2.0), lengths=1.0,
                         bending_rigidity=0.01, radius=0.0125,
                         force_scale=-0.05)
    jstate = jsys.make_state(fibers=fib,
                             shell=jleaves(shell, jperi.PeripheryState),
                             bodies=jleaves(bodies, JBodies))
    jmesh = jmake_mesh(4)
    return jsys.step_spmd(jshard_state(jstate, jmesh), jmesh, donate=False)


@pytest.mark.parametrize("world", [2, 4])
def test_coupled_step_across_processes(tmp_path, world):
    """`System.step_spmd` of `test_torch_spmd.py`'s coupled scene (a
    56-node shell split node-aligned, a body, 16 arcs) over 2 x 2 and 4 x
    1 processes x shards: the one-process 4-shard step's bits (solution,
    fibers, shell density, body) in every process, the same iterations in
    every process, the body's fields the same bits on every shard of every
    process, and within 1e-10 of the JAX package's `step_spmd` on 4
    devices."""
    recs, one = _case("coupled", world, tmp_path)
    assert one["converged"] and one["iters"] > 1
    for rec in recs:
        assert rec["shards"] == [16 // 4] * (4 // world)
        assert rec["iters"] == one["iters"]
        assert rec["residual_true"] == one["residual_true"]
        assert rec["fiber_error"] == one["fiber_error"]
        for key in ("sol", "x", "density", "position"):
            assert _same(rec[key], one[key]), key
    body0 = recs[0]["bodies"][0]
    for rec in recs:
        for body in rec["bodies"]:
            assert all(_same(body[f], body0[f]) for f in body0)

    js, jsol, jinfo = _jax_coupled_step()
    assert one["iters"] == int(jinfo.iters)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(recs[0]["sol"].numpy(), jsol, rtol=0,
                               atol=1e-10 * np.abs(jsol).max())
    np.testing.assert_allclose(recs[0]["x"].numpy(), np.asarray(js.fibers.x),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(recs[0]["position"].numpy(),
                               np.asarray(js.bodies.position), rtol=0,
                               atol=1e-10)


def test_flight_ring_across_two_processes(tmp_path):
    """An armed "full" step of the coupled scene over 2 processes x 2
    shards: every shard of both processes writes the one-process 4-shard
    step's ring, bit for bit (the recorder's pmax / pmin gather across the
    processes)."""
    recs, one = _case("flight", 2, tmp_path)
    rows0, count0 = one["flight"][0]
    assert int(count0) == 1 and one["converged"]
    for rec in recs + [one]:
        for rows, count in rec["flight"]:
            assert _same(rows.view(torch.int32), rows0.view(torch.int32))
            assert _same(count, count0)


def test_tree_step_across_two_processes(tmp_path):
    """``pair_evaluator = "tree"`` over 2 processes x 2 shards: every
    process builds the plan from the all-gathered positions, and the step
    gives the one-process sharded tree step's bits in both processes."""
    recs, one = _case("tree", 2, tmp_path)
    assert one["converged"]
    for rec in recs:
        assert rec["iters"] == one["iters"]
        assert _same(rec["sol"], one["sol"]) and _same(rec["x"], one["x"])


def _small_config(path):
    rng = np.random.default_rng(3)
    cfg = Config()
    cfg.params.dt_initial = cfg.params.dt_max = cfg.params.dt_write = 0.01
    cfg.params.t_final = 0.01
    cfg.params.gmres_tol = 1e-10
    cfg.background.scale_factor = [0.5, 0.0, 0.0]
    cfg.background.components = [1, 0, 2]
    for _ in range(4):
        fib = Fiber(length=1.0, bending_rigidity=2.5e-3, force_scale=-0.05,
                    n_nodes=16)
        d = rng.normal(size=3)
        fib.fill_node_positions(rng.uniform(-2, 2, 3), d / np.linalg.norm(d))
        cfg.fibers.append(fib)
    cfg.save(path)


def test_cli_in_two_processes(tmp_path):
    """Two processes run the port's CLI on a tiny config, each in its own
    directory, joined through the SKELLY_* variables: both exit 0, both
    log the runtime, and each writes its own trajectory (no writer rank,
    as in the JAX package), the same frames in both."""
    import torch_multihost_worker as w

    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    port = free_port()
    cmds = []
    for rank in range(2):
        run_dir = tmp_path / f"proc{rank}"
        run_dir.mkdir()
        _small_config(str(run_dir / "skelly_config.toml"))
        cmds.append(([sys.executable, "-m", "skellysim_tpu_torch",
                      "--device=cpu", "--config-file=skelly_config.toml"],
                     w.worker_env(SKELLY_COORDINATOR=f"localhost:{port}",
                                  SKELLY_NUM_PROCS="2",
                                  SKELLY_PROC_ID=str(rank)),
                     run_dir))
    outs = _run_all(cmds, tmp_path, "cli")
    frames = []
    for rank, out in enumerate(outs):
        assert "multi-process runtime" in out, out
        assert f"'process_index': {rank}, 'process_count': 2" in out, out
        assert "Finished at t=0.01" in out, out
        reader = TrajectoryReader(str(tmp_path / f"proc{rank}"
                                      / "skelly_sim.out"))
        assert len(reader) == 2
        frames.append(reader.load_frame(1))
    xa = np.stack([m["x_"] for m in frames[0]["fibers"][1]])
    xb = np.stack([m["x_"] for m in frames[1]["fibers"][1]])
    assert np.array_equal(xa, xb)
