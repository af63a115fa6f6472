"""Exit-code-gated dynamic-instability ensemble smoke, on the CPU.

    python -m skellysim_tpu_torch.scenarios.smoke

Counterpart of `skellysim_tpu.scenarios.smoke`: a small confined DI sweep
(a 60-node spherical periphery, a nucleating body with 2 sites, 2 members
on the ``"vmap"`` plan), undersized at 2 fiber slots so that nucleation
outgrows the first capacity rung. Gates:

* both members finish their horizon with at least one nucleation applied;
* at least one growth reseat happened;
* every reseat landed on a rung `ScenarioEnsemble` holds a scheduler for,
  and every rung is one of `system.buckets`' geometric rungs (the JAX
  smoke's "zero warm-path compiles" gate has no eager counterpart: the
  port compiles no program per rung).

Exits 0 on success, 1 with a message on any violation.
"""

from __future__ import annotations

import sys


def main() -> int:
    import numpy as np
    import torch

    from ..bodies import bodies as bd
    from ..ensemble.scheduler import MemberSpec
    from ..fibers import container as fc
    from ..params import DynamicInstability, Params
    from ..periphery import periphery as peri
    from ..periphery.precompute import precompute_body, precompute_periphery
    from ..scenarios import ScenarioEnsemble
    from ..system import System
    from ..system.buckets import GEOMETRIC_FIBER_LADDER, next_fiber_capacity
    from ..utils.rng import SimRNG

    params = Params(
        eta=1.0, dt_initial=0.02, dt_write=0.02, t_final=0.08,
        gmres_tol=1e-8, adaptive_timestep_flag=False,
        dynamic_instability=DynamicInstability(
            n_nodes=8, v_growth=0.2, f_catastrophe=0.1,
            nucleation_rate=100.0, min_length=0.3, radius=0.0125,
            bending_rigidity=0.01))

    pdata = precompute_periphery("sphere", n_nodes=60, radius=2.5, eta=1.0,
                                 device="cpu")
    shell = peri.make_state(pdata["nodes"], pdata["normals"],
                            pdata["quadrature_weights"],
                            pdata["stresslet_plus_complementary"],
                            pdata["M_inv"], dtype=torch.float64)
    shape = peri.PeripheryShape(kind="sphere", radius=2.5)
    bdata = precompute_body("sphere", 40, radius=0.4)
    rng = np.random.default_rng(3)
    sites = rng.standard_normal((2, 3))
    sites = 0.4 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
    bodies = bd.make_group(bdata["node_positions_ref"],
                           bdata["node_normals_ref"], bdata["node_weights"],
                           nucleation_sites_ref=sites[None], radius=0.4)
    system = System(params, shell_shape=shape, device="cpu")

    members = []
    for i in range(2):
        x = np.tile(np.linspace(0.0, 0.8, 8)[None, :, None], (2, 1, 3))
        x += 0.6 + 0.1 * i
        fibers = fc.make_group(x, lengths=0.8 * np.sqrt(3.0),
                               bending_rigidity=0.01, radius=0.0125)
        # 2 slots, both live: the first nucleation forces a growth reseat
        state = system.make_state(fibers=fibers, bodies=bodies, shell=shell)
        members.append(MemberSpec(member_id=f"m{i}", state=state,
                                  t_final=params.t_final,
                                  rng=SimRNG(17).member(i)))

    records: list = []
    se = ScenarioEnsemble(system, members, batch=2, metrics=records.append)
    finished = se.run(max_rounds=60)

    steps = [r for r in records if r.get("event") == "step"]
    nucleations = sum(r["nucleations"] for r in steps)
    growth = [r for r in records if r.get("event") == "growth"]
    rungs = sorted(se._scheds)
    reseated_to = {next_fiber_capacity(r["capacity"] + 1) for r in growth}

    problems = []
    if sorted(finished) != ["m0", "m1"]:
        problems.append(f"members did not finish: {finished}")
    if nucleations < 1:
        problems.append("no nucleation was applied")
    if se.reseats < 1:
        problems.append("no growth reseat happened (capacity never filled)")
    if not reseated_to <= set(rungs) or any(
            r not in GEOMETRIC_FIBER_LADDER for r in rungs):
        problems.append(f"reseats landed on {sorted(reseated_to)}, "
                        f"off the scheduler rungs {rungs}")
    if problems:
        for p in problems:
            print(f"scenario smoke FAILED: {p}", file=sys.stderr)
        return 1
    print(f"scenario smoke ok: 2 confined DI members finished, "
          f"{nucleations} nucleation(s), {se.reseats} growth reseat(s) "
          f"across rungs {rungs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
