"""The port's member meshes (`make_member_mesh`, `shard_ensemble`,
`make_2d_mesh`) against the one-device ensemble and the JAX package's.

* tests/test_ensemble.py's 8-member equivalence: the members on 8 CPU
  shards of a member mesh step to the one-device round's iterations and
  fibers (rtol 1e-9; in "unroll", where every lane is its own trial on
  either side, the bits), and to the JAX package's vmap round's; a batch
  the mesh does not divide raises "not divisible";
* `make_2d_mesh`'s shape and its error, and a member group's fiber ring
  through `System.step_spmd` against `System.step` at 5e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_system
from skellysim_tpu.ensemble import EnsembleRunner as JRunner
from skellysim_tpu_torch.ensemble import EnsembleRunner
from skellysim_tpu_torch.parallel import (FIBER_AXIS, MEMBER_AXIS,
                                          ShardedEnsemble, gather_ensemble,
                                          make_2d_mesh, make_member_mesh,
                                          shard_ensemble, shard_state)
from torch_jax_state import port_state, port_system

#: the reference's backend-agreement gate (`kernel_test.cpp:93`)
GATE = 5e-9


@pytest.fixture(scope="module")
def members():
    """tests/test_ensemble.py's ensemble system (one 8-node fiber in a
    background flow, adaptive dt) and 8 members with distinct geometry
    and dt, in both packages."""
    jsys, base = _make_system(n_fibers=1, n_nodes=8, dtype=jnp.float64)
    jsys.params = dataclasses.replace(
        jsys.params, adaptive_timestep_flag=True, dt_max=4e-3,
        dt_write=2e-3, fiber_error_tol=0.1, t_final=1.0)
    jstates = [base._replace(
        fibers=base.fibers._replace(x=base.fibers.x + 0.01 * i),
        dt=jnp.asarray(1e-3 * (1 + 0.1 * i), dtype=jnp.float64))
        for i in range(8)]
    return jsys, jstates, port_system(jsys), [port_state(s)
                                              for s in jstates]


@pytest.mark.parametrize("impl", ["vmap", "unroll"])
def test_member_axis_shards_across_mesh(members, impl):
    jsys, jstates, tsys, tstates = members
    runner = EnsembleRunner(tsys, batch_impl=impl)
    t_final = [0.01] * 8
    ens = runner.make_ensemble(tstates, t_final)
    mesh = make_member_mesh(8, device="cpu")
    assert mesh.shape == {MEMBER_AXIS: 8}
    sharded = shard_ensemble(ens, mesh)
    assert isinstance(sharded, ShardedEnsemble) and len(sharded.parts) == 8
    jr = JRunner(jsys, batch_impl="vmap")
    jens = jr.make_ensemble(jstates, t_final)
    ref, sh = ens, sharded
    for _ in range(2):
        ref, info_ref = runner.step(ref)
        sh, info_sh = runner.step(sh)
        jens, jinfo = jr.step(jens)
        np.testing.assert_array_equal(info_sh.iters, info_ref.iters)
        np.testing.assert_array_equal(info_sh.iters, np.asarray(jinfo.iters))
        np.testing.assert_array_equal(info_sh.accepted, info_ref.accepted)
        got = gather_ensemble(sh)
        np.testing.assert_allclose(got.states.fibers.x.numpy(),
                                   ref.states.fibers.x.numpy(), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got.states.fibers.x.numpy(),
                                   np.asarray(jens.states.fibers.x),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(got.states.time, ref.states.time)
        if impl == "unroll":
            assert torch.equal(got.states.fibers.x, ref.states.fibers.x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_ensemble(runner.make_ensemble([tstates[0]] * 3, [0.1] * 3),
                       mesh)


def test_member_mesh_of_two_shards_keeps_lane_order(members):
    """Two shards of four lanes: `gather_ensemble` of `shard_ensemble` is
    the ensemble, lane for lane, and a round keeps each lane's time."""
    _, _, tsys, tstates = members
    runner = EnsembleRunner(tsys, batch_impl="vmap")
    ens = runner.make_ensemble(tstates, [0.01] * 8)
    sharded = shard_ensemble(ens, make_member_mesh(2, device="cpu"))
    assert [len(p.t_final) for p in sharded.parts] == [4, 4]
    back = gather_ensemble(sharded)
    assert torch.equal(back.states.fibers.x, ens.states.fibers.x)
    np.testing.assert_array_equal(back.states.dt, ens.states.dt)
    out, info = runner.step(sharded)
    assert len(info.iters) == 8
    np.testing.assert_array_equal(gather_ensemble(out).states.time,
                                  info.t)


def test_2d_mesh_shape_error_and_fiber_group_step():
    """(member, fiber) = (2, 4) on the CPU: the shape, the error on a
    machine without the cards, and member group 1's fiber ring stepping a
    coupled scene through `step_spmd` to `System.step`'s answer."""
    from test_torch_spmd import PARAMS, SHAPE, _coupled_state

    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_parts

    mesh = make_2d_mesh(2, 4, device="cpu")
    assert mesh.shape == {MEMBER_AXIS: 2, FIBER_AXIS: 4}
    assert mesh.size == 8
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 8 devices"):
            make_2d_mesh(2, 4)
    group = mesh.fiber_group(1)
    assert group.shape == {FIBER_AXIS: 4}
    with pytest.raises(ValueError, match="member, fiber"):
        group.fiber_group(0)
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    state = _coupled_state(system, make_coupled_parts(56, 50))
    ref = system.step(state)
    new, sol, info = system.step_spmd(shard_state(state, group), group)
    assert info.converged and info.iters == ref[2].iters
    assert float((sol - ref[1]).abs().max()) <= GATE * float(
        ref[1].abs().max())
