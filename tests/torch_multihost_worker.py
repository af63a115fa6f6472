"""Worker of `tests/test_torch_multihost.py`: one process of a port run
whose mesh spans processes, over `gloo` on the CPU.

    python tests/torch_multihost_worker.py CASE PORT RANK WORLD OUT_DIR

joins the other WORLD - 1 processes through
`skellysim_tpu_torch.parallel.multihost.initialize`
(``tcp://localhost:PORT``), runs CASE on a mesh of 4 shards (4 / WORLD a
process) and saves what the test compares to ``OUT_DIR/CASE_RANK.pt``.
WORLD = 1 is the one-process run of the same case (all 4 shards, no
process group), the bits the others are held to: run beside them with the
same environment, it starts with the same math-library threads (the
blocked products of MKL give other last bits under another thread count).

* ``ring``: `ring_stokeslet` of the 16-point cloud of the JAX package's
  two-process test (`tests/multihost_worker.py`), gathered to every process;
* ``coupled``: one `System.step_spmd` of `test_torch_spmd.py`'s coupled
  scene (a 56-node shell split node-aligned, a body, 16 arcs);
* ``tree``: one `System.step_spmd` under ``pair_evaluator = "tree"``
  (20 arcs, every slot active).

On four cards (`tests/test_torch_gpu.py`, one process a card over `nccl`;
WORLD = 1: one process driving the four cards):

* ``cards``: kernels E and F at their full-width shapes (640,000 sources
  and targets; 8,000 sources onto 128,000 targets), each shard's output
  and the milliseconds a call; then one "mixed" and one "full"
  `System.step_spmd` of `cards_scene` (2,000 arcs x 64 nodes in a
  2,000-node sphere shell), each timed.

The scenes are importable, so that the test builds the very same inputs
in one process. The worker imports the port only.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from skellysim_tpu_torch.fibers import container as fc  # noqa: E402
from skellysim_tpu_torch.params import Params  # noqa: E402
from skellysim_tpu_torch.periphery import periphery as peri  # noqa: E402
from skellysim_tpu_torch.system import BackgroundFlow, System  # noqa: E402
from skellysim_tpu_torch.testing import make_coupled_parts  # noqa: E402

#: `tests/test_torch_spmd.py`'s step parameters and shell shape
PARAMS = dict(eta=1.0, dt_initial=1e-3, t_final=1e-2, gmres_tol=1e-10,
              adaptive_timestep_flag=False)
SHAPE = peri.PeripheryShape(kind="sphere", radius=6.0)
#: shards of every case's mesh, over all processes
SHARDS = 4


def arcs(n_fibers=16, n_nodes=16, seed=5, box=4.0, curvature=0.5):
    """`test_torch_spmd._arcs`: circular arcs of unit length."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-box, box, (n_fibers, 3))
    dirs = rng.normal(size=(n_fibers, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    perp = np.cross(dirs, rng.normal(size=(n_fibers, 3)))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    t = np.linspace(0.0, 1.0, n_nodes)[None, :, None]
    R = 1.0 / curvature
    return (origins[:, None, :] + R * np.sin(t / R) * dirs[:, None, :]
            + R * (1.0 - np.cos(t / R)) * perp[:, None, :])


def fibers(**kw):
    return fc.make_group(arcs(**kw), lengths=1.0, bending_rigidity=0.01,
                         radius=0.0125, force_scale=-0.05)


def coupled_scene(**over):
    """(system, state) of `test_torch_spmd._coupled_state` (``over``: more
    parameters)."""
    shell, _, bodies = make_coupled_parts(56, 50)
    system = System(Params(**PARAMS, **over), shell_shape=SHAPE,
                    device="cpu")
    return system, system.make_state(fibers=fibers(seed=7, box=2.0),
                                     shell=shell, bodies=bodies)


def tree_scene():
    """(system, state) of `test_torch_spmd.test_spmd_tree_branch_matches
    _tree_step`: 20 arcs in a cube of side 4, a depth-2 tree."""
    system = System(Params(**PARAMS, pair_evaluator="tree", tree_tol=1e-3),
                    device="cpu")
    return system, system.make_state(
        fibers=fibers(n_fibers=20, seed=11, box=2.0),
        background=BackgroundFlow.make(uniform=(1.0, 0.0, 0.0),
                                       dtype=torch.float64, device="cpu"))


def ring_cloud():
    """(r, f): the JAX two-process test's 16 points and forces."""
    rng = np.random.default_rng(0)
    return rng.uniform(-1.0, 1.0, (16, 3)), rng.standard_normal((16, 3))


def ring_blocks(family, n_dev, nt, ns, device, seed=0):
    """`tests/test_torch_gpu._ring_inputs`: per-shard f32 lists (targets,
    sources, payload), the first targets of every shard on the right
    neighbour's first sources."""
    rng = np.random.default_rng(seed)
    cols = 3 if family == "stokeslet" else 9
    src = rng.uniform(-5, 5, (n_dev * ns, 3))
    pay = rng.standard_normal((n_dev * ns, cols)) / ns
    trg = rng.uniform(-5, 5, (n_dev * nt, 3))
    k = min(nt, ns) // 2
    for j in range(n_dev):
        nb = (j + 1) % n_dev
        trg[j * nt:j * nt + k] = src[nb * ns:nb * ns + k]

    def shards(a, m):
        t = torch.as_tensor(a, dtype=torch.float32, device=device)
        return [b.contiguous() for b in t.split(m)]

    return shards(trg, nt), shards(src, ns), shards(pay, ns)


#: E's and F's full-width shapes: (family, targets, sources) over all shards
CARD_RINGS = (("stokeslet", 640_000, 640_000), ("stresslet", 128_000, 8_000))


def cards_scene(device, precision, n_fibers=2000, shell_n=2000):
    """(system, state): ``n_fibers`` arcs of 64 nodes (2,000: the
    ellipsoid's fiber count and width) in a cube of side 8 inside a sphere
    shell of ``shell_n`` nodes and radius 10.4 (host-built operators),
    "mixed" (E / F the f32 ring) or "full" (B / D a hop)."""
    shell, _, _ = make_coupled_parts(shell_n, 50, radius=10.0, device=device,
                                     precond_dtype=(torch.float32
                                                    if precision == "mixed"
                                                    else None))
    system = System(Params(eta=1.0, dt_initial=1e-3, gmres_tol=1e-8,
                           solver_precision=precision, kernel_impl="pallas",
                           refine_pair_impl="pallas_df"),
                    shell_shape=peri.PeripheryShape(kind="sphere",
                                                    radius=10.0),
                    device=device)
    g = fc.make_group(arcs(n_fibers=n_fibers, n_nodes=64, seed=3, box=4.0),
                      lengths=1.0, bending_rigidity=0.01, radius=0.0125,
                      force_scale=-0.05, device=device)
    return system, system.make_state(fibers=g, shell=shell)


def _cards(rec, mesh, world):
    """The ``cards`` case on ``mesh`` (one shard a card), into ``rec``."""
    import time

    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.parallel import gather_state, shard_state
    from skellysim_tpu_torch.parallel import multihost

    def sync():
        for d in set(mesh.local_devices):
            torch.cuda.synchronize(d)
        if world > 1:
            multihost.barrier()

    spread = mesh if mesh.spans_processes else None
    for family, nt, ns in CARD_RINGS:
        kern = getattr(ck, f"ring_{family}_f32")
        blocks = ring_blocks(family, 4, nt // 4, ns // 4, "cpu", seed=5)
        args = [[b[k].to(mesh.devices[k]) for k in mesh.local]
                for b in blocks]
        n0 = kern.launches
        kern(*args, mesh=spread)                        # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            out = kern(*args, mesh=spread)
        sync()
        rec[f"{family}_ms"] = (time.perf_counter() - t0) / 3e-3
        rec[f"{family}_launches"] = kern.launches - n0
        rec[family] = {k: o.cpu() for k, o in zip(mesh.local, out)}
    for precision in ("mixed", "full"):
        system, state = cards_scene(mesh.local_devices[0], precision)
        sharded = shard_state(state, mesh)
        del state
        n0 = {w.__name__: w.launches for w in ck.KERNEL_WRAPPERS}
        sync()
        t0 = time.perf_counter()
        new, _, info = system.step_spmd(sharded, mesh)
        sync()
        wall = time.perf_counter() - t0
        g = gather_state(new, shell_operators=False)
        rec[precision] = {
            "wall_s": wall, "iters": info.iters, "refines": info.refines,
            "converged": info.converged, "residual_true": info.residual_true,
            "x": g.fibers.x.cpu(),
            "launches": {w.__name__: w.launches - n0[w.__name__]
                         for w in ck.KERNEL_WRAPPERS
                         if w.launches > n0[w.__name__]}}


def step_record(system, state, mesh):
    """One `System.step_spmd` of ``state`` on ``mesh``: what the test
    compares, gathered to this process, and this process's shards' body
    fields."""
    from skellysim_tpu_torch.parallel import gather_state, shard_state

    new, sol, info = system.step_spmd(shard_state(state, mesh), mesh)
    g = gather_state(new)
    rec = {"sol": sol, "x": g.fibers.x, "iters": info.iters,
           "converged": info.converged, "residual": info.residual,
           "residual_true": info.residual_true,
           "fiber_error": info.fiber_error,
           "shards": [st.fibers.n_fibers for st in new.shards]}
    if new.shards[0].flight is not None:
        rec["flight"] = [(st.flight.rows, st.flight.count)
                         for st in new.shards]
    if g.shell is not None:
        rec["density"] = g.shell.density
    if g.bodies is not None:
        rec["position"] = g.bodies.position
        rec["bodies"] = [{f: getattr(st.bodies, f) for f in st.bodies._fields
                          if torch.is_tensor(getattr(st.bodies, f))}
                         for st in new.shards]
    return rec


def worker_env(**extra):
    """The environment of a worker: this one's without SKELLY_*, the repo
    on the path, one math-library thread (every process of a comparison
    starts alike; several share the box)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SKELLY_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.update(extra)
    return env


def main(case, port, rank, world, out_dir):
    from skellysim_tpu_torch.parallel import (initialize_multihost,
                                              make_mesh, process_info)
    from skellysim_tpu_torch.parallel import multihost
    from skellysim_tpu_torch.parallel.ring import ring_stokeslet

    cards = case == "cards"
    if world > 1:
        assert initialize_multihost(f"localhost:{port}", world, rank,
                                    device=None if cards else "cpu") is True
        assert multihost.runtime().backend == ("nccl" if cards else "gloo")
    info = process_info()
    assert info["process_index"] == rank, info
    assert info["process_count"] == world, info
    if cards:
        mesh = make_mesh(SHARDS) if world == 1 else make_mesh()
        assert mesh.devices == tuple(torch.device("cuda", k)
                                     for k in range(SHARDS))
    else:
        mesh = make_mesh(SHARDS // world, device="cpu")
    assert mesh.size == SHARDS and mesh.spans_processes == (world > 1)
    assert list(mesh.local) == list(range(rank * SHARDS // world,
                                          (rank + 1) * SHARDS // world))
    if case == "ring":
        r, f = (torch.as_tensor(a) for a in ring_cloud())
        rec = {"u": ring_stokeslet(r, r, f, 1.3, mesh=mesh)}
    elif case == "coupled":
        rec = step_record(*coupled_scene(), mesh)
    elif case == "tree":
        rec = step_record(*tree_scene(), mesh)
    elif case == "flight":
        rec = step_record(*coupled_scene(flight_window=4), mesh)
    elif case == "cards":
        rec = {}
        _cards(rec, mesh, world)
    else:
        raise ValueError(f"unknown case {case!r}")
    rec["process"] = info
    torch.save(rec, os.path.join(out_dir, f"{case}_{rank}.pt"))
    if world > 1:
        import torch.distributed as dist

        multihost.barrier()
        dist.destroy_process_group()
    print(f"TORCH-MULTIHOST-OK {case} {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
