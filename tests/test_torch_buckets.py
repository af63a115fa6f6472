"""The port's capacity buckets against the JAX package's.

`BucketPolicy.from_runtime`, `state_key`, `bucketize`, `bucketize_to` and
`admits` equal the JAX functions field for field on the same scenes; a
node-padded fiber group and a node-masked shell step to 1e-10 of the JAX
package's padded step, and their live rows to 1e-10 of the port's unpadded
step; inf / NaN written into the padding leaves the live outputs unchanged
(the runtime form of docs/audit.md's "Masking discipline"); and a config
with `[runtime]` ladders runs through both packages' CLIs to the same
trajectory within 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch

from skellysim_tpu.config import schema as jschema
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.periphery.precompute import precompute_periphery
from skellysim_tpu.system import System as JSystem
from skellysim_tpu.system import buckets as jbk
from skellysim_tpu_torch.config import schema as tschema
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.fibers import fd_fiber as tfd
from skellysim_tpu_torch.periphery import periphery as tperi
from skellysim_tpu_torch.system import buckets as tbk
from torch_jax_state import leaves, port_state, port_system

_SHELL_R = 2.5


@pytest.fixture(scope="module")
def shell_data():
    return precompute_periphery("sphere", n_nodes=40, radius=_SHELL_R,
                                eta=1.0)


def _jfibers(nf=3, n=8, seed=5):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 0.8, n)
    d = rng.normal(size=(nf, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = rng.uniform(-0.8, 0.8, (nf, 1, 3)) + t[None, :, None] * d[:, None]
    return jfc.make_group(x, lengths=0.8, bending_rigidity=0.01,
                          radius=0.0125, force_scale=-0.05)


def _jscene(shell_data, nf=3, n=8):
    p = JParams(eta=1.0, dt_initial=0.01, t_final=0.02, gmres_tol=1e-10,
                adaptive_timestep_flag=False)
    shape = jperi.PeripheryShape(kind="sphere", radius=_SHELL_R)
    jsys = JSystem(p, shell_shape=shape)
    d = shell_data
    shell = jperi.make_state(d["nodes"], d["normals"],
                             d["quadrature_weights"],
                             d["stresslet_plus_complementary"], d["M_inv"])
    return jsys, jsys.make_state(fibers=_jfibers(nf, n), shell=shell)


_RUNTIMES = [
    {},
    {"bucket_ladder": [-1]},
    {"bucket_ladder": [2, 5, 9], "node_ladder": [16, 32]},
    {"node_ladder": [8, 24], "shell_ladder": [48, 64], "grid_ladder": [24]},
]


@pytest.mark.parametrize("runtime", _RUNTIMES)
def test_policy_from_runtime_matches_jax(runtime):
    """The `[runtime]` table gives the JAX package's policy, rung for rung
    (exact integers)."""
    data = {"runtime": runtime}
    jp = jbk.BucketPolicy.from_runtime(jschema.load_runtime_config(data))
    tp = tbk.BucketPolicy.from_runtime(tschema.load_runtime_config(data))
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    for n in (1, 3, 8, 17, 40):
        assert tp.fiber_capacity(n) == jp.fiber_capacity(n)
        assert tp.shell_capacity(n) == jp.shell_capacity(n)
        assert (tbk.next_fiber_capacity(n, tp)
                == jbk.next_fiber_capacity(n, jp))
    assert tp.node_polymorphism == jp.node_polymorphism


@pytest.mark.parametrize("bad", [{"bucket_ladder": [3, 2]},
                                 {"node_ladder": [0]},
                                 {"bogus_ladder": [4]}])
def test_bad_runtime_tables_raise_as_in_jax(bad):
    data = {"runtime": bad}
    with pytest.raises(ValueError) as je:
        jschema.load_runtime_config(data)
    with pytest.raises(ValueError) as te:
        tschema.load_runtime_config(data)
    assert str(te.value) == str(je.value)


def _assert_group_equal(tg, jg):
    for k, v in leaves(jg).items():
        t = getattr(tg, k)
        if k == "rt_mats":
            if v is None:
                assert t is None
                continue
            for kk, vv in v.items():
                np.testing.assert_array_equal(getattr(t, kk).numpy(), vv)
        elif v is None:
            assert t is None
        else:
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


@pytest.mark.parametrize("runtime", _RUNTIMES[1:])
def test_bucketize_matches_jax(shell_data, runtime):
    """`bucketize` / `state_key` / `bucketize_to` / `admits` on a 3-fiber
    8-node scene with a 40-node shell: the same keys, and every padded
    field (fibers, runtime node matrices, shell) equal (exact)."""
    jsys, jstate = _jscene(shell_data)
    tstate = port_state(jstate)
    data = {"runtime": runtime}
    jp = jbk.BucketPolicy.from_runtime(jschema.load_runtime_config(data))
    tp = tbk.BucketPolicy.from_runtime(tschema.load_runtime_config(data))
    js, jkey = jbk.bucketize(jstate, jp)
    ts, tkey = tbk.bucketize(tstate, tp)
    assert tuple(tkey) == tuple(jkey) and tkey.describe() == jkey.describe()
    assert tbk.state_key(ts) == tkey
    _assert_group_equal(ts.fibers, js.fibers)
    for k, v in leaves(js.shell).items():
        t = getattr(ts.shell, k)
        assert (t is None) == (v is None), k
        if v is not None:
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    # bucketize is idempotent, and an explicit bigger key admits the scene
    assert tbk.bucketize(ts, tp)[1] == tkey
    big = tbk.BucketKey(fibers=((8, 16),), shell=64, rt_nodes=True)
    jbig = jbk.BucketKey(fibers=((8, 16),), shell=64, rt_nodes=True)
    assert tbk.admits(big, tstate) == jbk.admits(jbig, jstate) is True
    _assert_group_equal(tbk.bucketize_to(tstate, big).fibers,
                        jbk.bucketize_to(jstate, jbig).fibers)
    small = tbk.BucketKey(fibers=((2, 8),))
    assert not tbk.admits(small, tstate)
    assert not jbk.admits(jbk.BucketKey(fibers=((2, 8),)), jstate)
    with pytest.raises(ValueError, match="bucket holds 2"):
        tbk.bucketize_to(tstate, small)


def test_padded_group_and_masked_shell_step_match_jax(shell_data):
    """A fiber group padded 3 -> 4 slots and 8 -> 16 nodes a fiber with a
    shell padded 40 -> 48 quadrature rows: the port's step is within 1e-10
    of the JAX package's padded step (same iterations), its live rows are
    within 1e-10 of the port's unpadded step, and the padded solution
    entries are exact zeros."""
    jsys, jstate = _jscene(shell_data)
    pol = jbk.BucketPolicy(fiber_ladder=(4,), node_ladder=(16,),
                           shell_ladder=(48,))
    jpad, _ = jbk.bucketize(jstate, pol)
    jnew, jsol, jinfo = jsys.step(jpad)
    tsys = port_system(jsys)
    tpad = port_state(jpad)
    tnew, tsol, tinfo = tsys.step(tpad)
    assert tinfo.converged and tinfo.iters == int(jinfo.iters)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-10 * np.abs(jsol).max())
    np.testing.assert_allclose(tnew.fibers.x.numpy(),
                               np.asarray(jnew.fibers.x), rtol=0, atol=1e-10)
    # against the port's own unpadded step: live rows, exact-zero padding
    unew, usol, uinfo = tsys.step(port_state(jstate))
    np.testing.assert_allclose(tnew.fibers.x[:3, :8].numpy(),
                               unew.fibers.x.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tnew.shell.density[:120].numpy(),
                               unew.shell.density.numpy(), rtol=0,
                               atol=1e-10)
    assert float(tnew.shell.density[120:].abs().max()) == 0.0
    sol_mask = tpad.fibers.rt_mats.sol_mask
    fib = tsol[:4 * 4 * 16].reshape(4, -1)
    assert float(fib[:, ~sol_mask].abs().max()) == 0.0
    assert float(fib[3:].abs().max()) == 0.0
    # padded node rows and the inactive slot pass through bitwise
    assert torch.equal(tnew.fibers.x[:3, 8:], tpad.fibers.x[:3, 8:])
    assert torch.equal(tnew.fibers.x[3:], tpad.fibers.x[3:])


@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
def test_masking_discipline_poisoned_padding(shell_data, poison):
    """inf / NaN written into the padding leaves the live outputs
    unchanged, bitwise: (a) every field of an inactive capacity slot
    through a whole step; (b) the velocity at padded node rows through the
    fiber matvec, whose live rows and padded unit rows are unchanged; (c)
    the velocity at padded shell rows through the shell matvec and RHS."""
    jsys, jstate = _jscene(shell_data)
    tsys = port_system(jsys)
    pol = jbk.BucketPolicy(fiber_ladder=(4,), node_ladder=(16,),
                           shell_ladder=(48,))
    tpad = port_state(jbk.bucketize(jstate, pol)[0])
    clean = tsys.step(tpad)

    g = tpad.fibers
    dead = ~g.active

    def poison_field(t):
        if not t.is_floating_point():
            return t
        shape = (-1,) + (1,) * (t.ndim - 1)
        return torch.where(dead.reshape(shape), poison, t)

    bad = g._replace(**{k: poison_field(getattr(g, k))
                        for k in ("x", "tension", "length", "length_prev",
                                  "bending_rigidity", "radius", "penalty",
                                  "beta_tstep", "force_scale", "v_growth")})
    dirty = tsys.step(tpad._replace(fibers=bad))
    live = g.active
    assert dirty[2].iters == clean[2].iters
    assert torch.equal(dirty[0].fibers.x[live], clean[0].fibers.x[live])
    assert torch.equal(dirty[0].shell.density, clean[0].shell.density)
    n_live = 4 * 4 * 16
    assert torch.equal(dirty[1][n_live:], clean[1][n_live:])

    # (b) the fiber matvec with poisoned velocity at the padded node rows
    _, caches, _, _, _ = tsys._prep(tpad)
    c = caches[0]
    x = torch.randn(g.n_fibers, 4 * g.n_nodes, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    v = torch.randn(g.n_fibers, g.n_nodes, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    nm = g.rt_mats.node_mask
    v_bad = torch.where(nm[None, :, None], v, poison)
    vb = torch.zeros((g.n_fibers, 7), dtype=torch.float64)
    assert torch.equal(tfc.matvec(g, c, x, v_bad, vb),
                       tfc.matvec(g, c, x, v, vb))
    # (c) the shell with poisoned velocity at its padded rows
    sh = tpad.shell
    vs = torch.randn(sh.n_nodes, 3, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(3))
    vs_bad = torch.where(sh.node_mask[:, None], vs, poison)
    xs = torch.randn(3 * sh.n_nodes, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(4))
    assert torch.equal(tperi.matvec(sh, xs, vs_bad), tperi.matvec(sh, xs, vs))
    assert torch.equal(tperi.update_RHS(vs_bad, sh.node_mask),
                       tperi.update_RHS(vs, sh.node_mask))
    # the padded node rows' fiber error is excluded
    err = tfd.fiber_error(g.x, g.length, g.mats)
    assert torch.isfinite(err[live]).all()


def _ladder_config(path):
    from skellysim_tpu_torch.config import Config, Fiber

    cfg = Config()
    cfg.params.eta = 1.0
    cfg.params.dt_initial = 0.01
    cfg.params.dt_write = 0.01
    cfg.params.t_final = 0.02
    cfg.params.gmres_tol = 1e-10
    cfg.params.adaptive_timestep_flag = False
    rng = np.random.default_rng(4)
    fibers = []
    for i in range(3):
        f = Fiber(n_nodes=8, length=0.8, bending_rigidity=0.01,
                  force_scale=-0.05)
        d = rng.normal(size=3)
        f.fill_node_positions(rng.uniform(-1, 1, 3), d / np.linalg.norm(d))
        fibers.append(f)
    cfg.fibers = fibers
    cfg.background.uniform = [0.3, 0.0, 0.0]
    cfg.save(str(path))
    with open(path, "a") as fh:
        fh.write("\n[runtime]\nbucket_ladder = [-1]\nnode_ladder = [16]\n")


def test_ladder_config_runs_through_both_clis(tmp_path, caplog):
    """A config whose `[runtime]` ladders pad 3 x 8-node fibers onto a
    4 x 16 bucket runs through both CLIs: the port logs the bucket, and its
    trajectory (live rows only on the wire) is within 1e-10 of the JAX
    package's, frame for frame."""
    from skellysim_tpu import cli as jcli
    from skellysim_tpu.io import trajectory as jtraj
    from skellysim_tpu_torch import cli as tcli

    frames = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        cfg = d / "skelly_config.toml"
        _ladder_config(cfg)
        if who == "jax":
            jcli.run(str(cfg))
        else:
            with caplog.at_level("INFO", logger="skellysim_tpu_torch"):
                tcli.run(str(cfg), device="cpu")
        r = jtraj.TrajectoryReader(str(d / "skelly_sim.out"))
        frames[who] = [r.load_frame(i) for i in range(len(r))]
        r.close()
    assert "scene bucket: fibers[4x16] rt" in caplog.text
    assert len(frames["port"]) == len(frames["jax"]) == 3
    for fj, ft in zip(frames["jax"], frames["port"]):
        assert ft["time"] == fj["time"]
        a, b = fj["fibers"][1], ft["fibers"][1]
        assert len(a) == len(b) == 3
        for ma, mb in zip(a, b):
            assert mb["n_nodes_"] == ma["n_nodes_"] == 8
            np.testing.assert_allclose(np.asarray(mb["x_"]),
                                       np.asarray(ma["x_"]), rtol=0,
                                       atol=1e-10)
