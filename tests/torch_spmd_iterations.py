"""The "mixed" ellipsoid step's GMRES iterations and sweeps on the card,
one step from the same state through each path that differs from
`System.step` in how its f32 Krylov interior rounds. Not collected by
pytest.

    python tests/torch_spmd_iterations.py      # on a machine with a card

The state is chip_smoke.py's phase 6 (`make_ellipsoid_config`: 2,000
fibers x 64 nodes in an 8,000-node ellipsoid, precomputed on the card in
a temporary directory). The steps, in one process: `System.step` twice;
with the shell's operator product, then also its preconditioner product,
taken as 4 row blocks (the sharded step's GEMV shapes, nothing else
changed); `System.step_spmd` on 4 shards and on 1 shard of the card; the
ring evaluator's `System.step` on the 4-shard mesh. Prints each run's
iterations, sweeps, true residual and its per-sweep history rows
(cumulative iterations, the inner solve's implicit residual, the f64
residual after the sweep), and the card's name and power limit.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from skellysim_tpu_torch import precompute  # noqa: E402
from skellysim_tpu_torch.builder import build_simulation  # noqa: E402
from skellysim_tpu_torch.ops import cuda_build  # noqa: E402
from skellysim_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from skellysim_tpu_torch.parallel import make_mesh, shard_state  # noqa: E402
from skellysim_tpu_torch.periphery import periphery as peri  # noqa: E402
from skellysim_tpu_torch.system import System  # noqa: E402

ROW_BLOCKS = 4


def show(tag, info):
    rows = [[int(a), f"{b:.3e}", f"{c:.3e}"] for a, b, c in info.history]
    print(f"{tag}: {info.iters} iterations / {info.refines} sweeps, true "
          f"residual {info.residual_true:.3e}; per sweep {rows}", flush=True)


def in_row_blocks(op, x):
    m = op.shape[0] // ROW_BLOCKS
    return torch.cat([op[k * m:(k + 1) * m] @ x for k in range(ROW_BLOCKS)])


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this script measures the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(ck.SOURCES)) as pool:
        list(pool.map(cuda_build.build, ck.SOURCES))
    work = tempfile.mkdtemp(prefix="skelly_iters_")
    try:
        cfg = os.path.join(work, "skelly_config.toml")
        cs.make_ellipsoid_config(cfg, 2000, 8000)
        precompute.main([cfg, "--device=cuda"])
        system, state, _ = build_simulation(cfg, device="cuda")
        system.params = dataclasses.replace(system.params, gmres_history=8)
        show("System.step", system.step(state)[2])
        show("System.step again", system.step(state)[2])
        matvec, precond = peri.matvec, peri.apply_preconditioner
        try:
            peri.matvec = lambda shell, x, v: (in_row_blocks(
                shell.stresslet_plus_complementary, x) + v.reshape(-1))
            show("System.step, the shell operator by row blocks",
                 system.step(state)[2])
            peri.apply_preconditioner = lambda shell, x: in_row_blocks(
                shell.M_inv, x.to(shell.M_inv.dtype)).to(x.dtype)
            show("System.step, the operator and M_inv by row blocks",
                 system.step(state)[2])
        finally:
            peri.matvec, peri.apply_preconditioner = matvec, precond
        for n in (4, 1):
            mesh = make_mesh(n, device="cuda")
            show(f"System.step_spmd, {n} shard(s)",
                 system.step_spmd(shard_state(state, mesh), mesh)[2])
        ring = System(dataclasses.replace(system.params,
                                          pair_evaluator="ring"),
                      shell_shape=system.shell_shape, device="cuda",
                      mesh=make_mesh(4, device="cuda"))
        show("the ring evaluator's System.step, 4 shards",
             ring.step(state)[2])
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
