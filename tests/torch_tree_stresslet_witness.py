"""The tree stresslet's error on `chip_smoke.py` phase 12b's inputs, cut to
run on the CPU: the JAX package's `stresslet_tree` and the port's, each
against the dense double layer, on the same plan.

Phase 12b holds the port's tree stresslet (kernel H) against kernel D with
the shell's 8,000 nodes as sources and every node of the ellipsoid scene
(its 2,000 fibers x 64 nodes and the shell) as targets, at depth 5. This
script builds the same scene (the smoke's own `make_ellipsoid_config`,
the shell's quadrature nodes and inward normals, the white-noise density
of seed 11, the inputs rounded through f32 as the smoke does) and keeps
the whole shell as sources. A case ``F:K`` plans over the shell and the
first F fibers' nodes and sums at the shell and every K-th of those fiber
nodes: 131:1 and 500:1 are scenes cut to depth 3 and 4, and 2000:8 is
phase 12b's own depth-5 plan, summed at the shell and an eighth of the
fiber nodes (a target's sum depends only on the plan and its own leaf, so
those rows are the smoke's). For each case it prints one JSON line: the
plan, the field-normalized error (the smoke's measure, max_i |du_i| /
max_i |u_i|, over the rows summed) of each package's tree sum against the
dense f64 sum, as a multiple of the plan's tol, the two tree sums'
difference, and the pairs of the port's lists at every planned target
(`list_pairs`): near, far, the dense sum's, and far if each cell with at
most p^3 sources below it sent its sources instead of its p^3 proxies.

    JAX_PLATFORMS=cpu python tests/torch_tree_stresslet_witness.py
        [--cases 131:1 500:1 2000:8] [--tol 1e-4]

Not collected by pytest.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def scene():
    """(shell nodes, every fiber's nodes [fibers, 64, 3], f_dl [n, 3, 3])
    of phase 6 / 12b, at eta = 1."""
    import chip_smoke
    from skellysim_tpu_torch.periphery.precompute import _shape_for_periphery

    with tempfile.TemporaryDirectory() as work:
        config = chip_smoke.make_ellipsoid_config(
            os.path.join(work, "skelly_config.toml"), 2000, 8000)
    per = config.periphery
    spec = _shape_for_periphery("ellipsoid", per.n_nodes, a=per.a, b=per.b,
                                c=per.c)
    nodes, normals = spec.nodes, -spec.node_normals
    fibers = np.stack([np.asarray(f.x).reshape(-1, 3)
                       for f in config.fibers])
    rho = np.random.default_rng(11).standard_normal(nodes.shape)
    f_dl = 2.0 * normals[:, :, None] * rho[:, None, :]
    return nodes, fibers, f_dl


def list_pairs(ttc, plan, src, trg, S):
    """The pairs of kernel H's lists (`ops.treecode.tree_operands`) with
    every planned target: near, far, dense, and far with each cell of at
    most p^3 sources summed through its sources."""
    import torch

    from skellysim_tpu_torch.ops import evaluator as tev

    anchors = tev.make_pair(plan, "cpu").anchors
    out = {"dense": len(src) * len(trg)}
    p3 = plan.order ** 3
    for field in ("near", "far"):
        _, _, _, items, segs, _, counts = ttc.tree_operands(
            plan, anchors, torch.tensor(src), torch.tensor(S),
            torch.tensor(trg), fields=(field,))
        seg_trg = torch.repeat_interleave(items[:, 1], items[:, 3])
        seg_ids = torch.cat([torch.arange(g, g + n)
                             for _, _, g, n in items.tolist()])
        lens = segs[seg_ids, 1]
        out[field] = int((seg_trg * lens).sum())
        if field == "far":
            lo = anchors[0]
            cen = ttc._cell_centers(plan, lo, plan.depth, torch.float64)
            sb, pb, _ = ttc._bucket(plan, lo, cen, torch.tensor(src),
                                    torch.tensor(S))
            cell_n = ttc._upward(plan, lo, sb, pb, counts,
                                 torch.float64)[2]
            cell = (segs[seg_ids, 0] - plan.n_leaves * plan.max_occ) // p3
            out["far_small_cells_as_sources"] = int(
                (seg_trg * torch.clamp_max(cell_n[cell], p3)).sum())
    return out


def field_rel(u, ref):
    """max_i |du_i| / max_i |u_i| (the smoke's `_field_rel`)."""
    return float(np.linalg.norm(u - ref, axis=1).max()
                 / np.linalg.norm(ref, axis=1).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", nargs="+", default=["131:1", "500:1",
                                                   "2000:8"])
    ap.add_argument("--tol", type=float, default=1e-4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from skellysim_tpu.ops import treecode as jtc
    from skellysim_tpu_torch.ops import kernels as tk
    from skellysim_tpu_torch.ops import treecode as ttc

    nodes, fibers, f_dl = scene()
    f32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)
    src, S = f32(nodes), f32(f_dl)
    for case in args.cases:
        n_fib, stride = map(int, case.split(":"))
        fib = fibers[:n_fib].reshape(-1, 3)
        every = np.concatenate([fib, nodes])
        plan = ttc.plan_tree(every, tol=args.tol)
        assert plan.__dict__ == jtc.plan_tree(every, tol=args.tol).__dict__
        trg = f32(np.concatenate([fib[::stride], nodes]))
        pairs = list_pairs(ttc, plan, src, f32(every), S.reshape(-1, 9))
        t0 = time.perf_counter()
        ref = tk.stresslet_direct(torch.tensor(src), torch.tensor(trg),
                                  torch.tensor(S), 1.0).numpy()
        t1 = time.perf_counter()
        u_port = ttc.stresslet_tree(plan, torch.tensor(src),
                                    torch.tensor(trg), torch.tensor(S),
                                    1.0).numpy()
        t2 = time.perf_counter()
        u_jax = np.asarray(jtc.stresslet_tree(
            plan, jnp.asarray(src), jnp.asarray(trg), jnp.asarray(S), 1.0))
        t3 = time.perf_counter()
        err_port, err_jax = field_rel(u_port, ref), field_rel(u_jax, ref)
        print(json.dumps({
            "fibers": n_fib, "stride": stride, "sources": len(src),
            "planned": len(every), "targets": len(trg),
            "depth": plan.depth, "order": plan.order,
            "max_occ": plan.max_occ, "tol": plan.tol,
            "jax_err": err_jax, "jax_err_over_tol": err_jax / plan.tol,
            "port_err": err_port, "port_err_over_tol": err_port / plan.tol,
            "port_vs_jax": field_rel(u_port, u_jax), "list_pairs": pairs,
            "seconds": {"dense": t1 - t0, "port": t2 - t1,
                        "jax": t3 - t2}}), flush=True)


if __name__ == "__main__":
    main()
