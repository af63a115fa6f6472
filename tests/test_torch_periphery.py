"""The port's periphery (shapes, quadrature, precompute, operators, wall
physics) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays. Shapes and quadrature are numpy in both packages (the port
keeps its own copies), so they agree to round-off; the dense operator is
built by different frameworks with the same arithmetic, so it agrees to
~1e-12, and its inverse (scipy in both) to ~1e-9 of its largest entry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from skellysim_tpu import builder as jbuilder
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.periphery import precompute as jpre
from skellysim_tpu.periphery import quadrature as jquad
from skellysim_tpu.periphery import shapes as jshapes
from skellysim_tpu_torch import builder as tbuilder
from skellysim_tpu_torch.config import schema
from skellysim_tpu_torch.periphery import periphery as tperi
from skellysim_tpu_torch.periphery import precompute as tpre
from skellysim_tpu_torch.periphery import quadrature as tquad
from skellysim_tpu_torch.periphery import shapes as tshapes

ENVELOPE = {"height": "0.5 * T * ((1 + 2*x/length)**p1) * "
                      "((1 - 2*x/length)**p2) * length",
            "T": 0.72, "p1": 0.4, "p2": 0.2, "length": 4.0,
            "lower_bound": -2.0, "upper_bound": 2.0, "n_nodes_target": 120}


def _specs(mod):
    return [mod.sphere_shape(150, radius=1.3),
            mod.ellipsoid_shape(150, a=2.0, b=1.2, c=0.9),
            mod.surface_of_revolution_shape(ENVELOPE, scale_factor=1.04)]


def test_shapes_and_quadrature_equal_jax():
    """Nodes, normals and Reeger-Fornberg weights for all three shapes
    equal the JAX package's to 1e-13 (the same numpy arithmetic)."""
    for js, ts in zip(_specs(jshapes), _specs(tshapes)):
        np.testing.assert_allclose(ts.nodes, js.nodes, rtol=0, atol=1e-13)
        np.testing.assert_allclose(ts.node_normals, js.node_normals, rtol=0,
                                   atol=1e-13)
        tris = ConvexHull(js.nodes).simplices
        wj = jquad.surface_quadrature_weights(js.nodes, tris, js.gradh)
        wt = tquad.surface_quadrature_weights(ts.nodes, tris, ts.gradh)
        np.testing.assert_allclose(wt, wj, rtol=1e-13, atol=0)


def test_quadrature_sphere_area():
    """The sphere-area oracle of tests/test_periphery.py: 400 nodes
    integrate the area of a sphere of radius 1.3 to 5e-5."""
    spec = tshapes.sphere_shape(400, radius=1.3)
    tris = ConvexHull(spec.nodes).simplices
    w = tquad.surface_quadrature_weights(spec.nodes, tris, spec.gradh)
    exact = 4 * np.pi * 1.3**2
    assert abs(w.sum() - exact) / exact < 5e-5


@pytest.fixture(scope="module")
def sphere_npz():
    """The ~100-node sphere precompute from both packages (host path)."""
    return (jpre.precompute_periphery("sphere", 100, radius=2.0, eta=1.0),
            tpre.precompute_periphery("sphere", 100, radius=2.0, eta=1.0,
                                      device="cpu"))


def test_host_precompute_matches_jax(sphere_npz):
    """Same npz keys; quadrature to round-off, the float64 operator to
    1e-12 and the scipy inverse to 1e-9 of their largest entries."""
    j, t = sphere_npz
    assert set(t) == set(j)
    for k in ("nodes", "normals", "quadrature_weights"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-13, atol=1e-15)
    op = j["stresslet_plus_complementary"]
    np.testing.assert_allclose(t["stresslet_plus_complementary"], op, rtol=0,
                               atol=1e-12 * np.abs(op).max())
    np.testing.assert_allclose(t["M_inv"], j["M_inv"], rtol=0,
                               atol=1e-9 * np.abs(j["M_inv"]).max())


def test_device_operator_builder_on_cpu(sphere_npz):
    """The device builder (here on the CPU) assembles the same f64
    operator and inverts it in f64 before storing f32: M_inv agrees with
    the host inverse to f32 rounding, and the inverse check is small."""
    j, _ = sphere_npz
    stats = {}
    M, M_inv = tperi.build_shell_operator_device(
        j["nodes"], j["normals"], j["quadrature_weights"], device="cpu",
        timings=stats)
    assert M.dtype == torch.float64 and M_inv.dtype == torch.float32
    op = j["stresslet_plus_complementary"]
    np.testing.assert_allclose(M.numpy(), op, rtol=0,
                               atol=1e-12 * np.abs(op).max())
    np.testing.assert_allclose(M_inv.numpy(), j["M_inv"], rtol=0,
                               atol=1e-6 * np.abs(j["M_inv"]).max())
    assert tperi.inverse_residual(M, M_inv) < 1e-4
    assert set(stats) == {"assembly_s", "inverse_s"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_both_builders(tmp_path, sphere_npz, writer):
    """A precompute npz written by either package builds the same shell in
    `skellysim_tpu.builder.build_periphery` and the port's builder."""
    data = sphere_npz[0] if writer == "jax" else sphere_npz[1]
    np.savez(tmp_path / "periphery_precompute.npz", **data)
    cfg = schema.SphericalPeriphery(n_nodes=100, radius=2.0)
    jstate, jshape = jbuilder.build_periphery(cfg, str(tmp_path), jnp.float64)
    tstate, tshape = tbuilder.build_periphery(cfg, str(tmp_path),
                                              torch.float64, "cpu")
    assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
    for k in ("nodes", "normals", "weights", "M_inv",
              "stresslet_plus_complementary"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)))


SHAPES = [dict(kind="sphere", radius=2.0),
          dict(kind="ellipsoid", abc=(2.0, 1.4, 1.1)),
          dict(kind="generic")]


def _shell_pair(sphere_npz):
    j, _ = sphere_npz
    args = (j["nodes"], j["normals"], j["quadrature_weights"],
            j["stresslet_plus_complementary"], j["M_inv"])
    return (jperi.make_state(*args, dtype=jnp.float64),
            tperi.make_state(*args, dtype=torch.float64, device="cpu"))


def test_shell_operators_match_jax(sphere_npz):
    """matvec, apply_preconditioner (f64 and f32 M_inv), update_RHS and
    the double-layer flow (f_dl = 2 eta n (x) rho) vs JAX at 1e-12."""
    js, ts = _shell_pair(sphere_npz)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300)
    v = rng.standard_normal((100, 3))
    trg = rng.uniform(-1.5, 1.5, (50, 3))
    eta = 1.3

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())

    close(tperi.matvec(ts, torch.as_tensor(x), torch.as_tensor(v)),
          jperi.matvec(js, jnp.asarray(x), jnp.asarray(v)))
    close(tperi.apply_preconditioner(ts, torch.as_tensor(x)),
          jperi.apply_preconditioner(js, jnp.asarray(x)))
    close(tperi.update_RHS(torch.as_tensor(v)), jperi.update_RHS(jnp.asarray(v)))
    close(tperi.flow(ts, torch.as_tensor(trg), torch.as_tensor(x), eta),
          jperi.flow(js, jnp.asarray(trg), jnp.asarray(x), eta))
    ts32 = ts._replace(M_inv=ts.M_inv.float())
    js32 = js._replace(M_inv=js.M_inv.astype(jnp.float32))
    got = tperi.apply_preconditioner(ts32, torch.as_tensor(x))
    assert got.dtype == torch.float64
    ref = np.asarray(jperi.apply_preconditioner(js32, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s["kind"])
def test_wall_physics_matches_jax(shape):
    """fiber_steric_force (batched over fibers, the clamped first node
    skipped) and check_collision for sphere, ellipsoid and generic shells
    vs the JAX per-fiber functions at 1e-12."""
    jshape, tshape = jperi.PeripheryShape(**shape), tperi.PeripheryShape(**shape)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((5, 12, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    # nodes near and across the wall: |p| from 0.9 to 2.1
    pts = u * rng.uniform(0.9, 2.1, (5, 12, 1))
    skip = np.array([True, False, True, False, False])
    got = tperi.fiber_steric_force(tshape, torch.as_tensor(pts), 20.0, 0.05,
                                   torch.as_tensor(skip)).numpy()
    hit = tperi.check_collision(tshape, torch.as_tensor(pts), 0.1).numpy()
    assert hit.shape == (5,)
    for i in range(5):
        ref = np.asarray(jperi.fiber_steric_force(
            jshape, jnp.asarray(pts[i]), 20.0, 0.05, jnp.asarray(skip[i])))
        np.testing.assert_allclose(got[i], ref, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(ref).max(), 1.0))
        assert hit[i] == bool(jperi.check_collision(
            jshape, jnp.asarray(pts[i]), 0.1))
        # one fiber well inside never collides
        inside = pts[i] / np.linalg.norm(pts[i], axis=-1, keepdims=True) * 0.5
        assert not bool(tperi.check_collision(tshape,
                                              torch.as_tensor(inside), 0.1))
    if shape["kind"] != "generic":
        assert hit.any() and np.abs(got).max() > 0


def test_revolution_precompute_writes_back_node_count(tmp_path):
    """``python -m skellysim_tpu_torch.precompute``'s path for a surface of
    revolution writes the envelope fit state and the node count it chose
    back into the config, which the JAX package's loader and builder then
    read like their own."""
    from skellysim_tpu.config import schema as jschema

    from skellysim_tpu_torch.precompute import precompute_from_config

    cfg = schema.ConfigRevolution()
    cfg.periphery.envelope = schema.EnvelopeConfig(ENVELOPE)
    path = str(tmp_path / "skelly_config.toml")
    cfg.save(path)
    stats = precompute_from_config(path, verbose=False, device="cpu")
    assert stats["quadrature_s"] > 0 and stats["inverse_residual"] < 1e-10
    with np.load(tmp_path / "periphery_precompute.npz") as z:
        n = z["nodes"].shape[0]
        assert {"env_coef", "env_domain", "env_bounds"} <= set(z.files)
    assert n > 0 and schema.load_config(path).periphery.n_nodes == n
    jcfg = jschema.load_config(path)
    assert jcfg.periphery.n_nodes == n
    jstate, jshape = jbuilder.build_periphery(jcfg.periphery, str(tmp_path),
                                              jnp.float64)
    assert jshape.kind == "generic" and jstate.n_nodes == n


def test_precompute_defaults_to_the_card(tmp_path):
    """``python -m skellysim_tpu_torch.precompute`` without ``--device``
    builds the shell operator on the card (float32 inverse); with no card
    it raises before any work instead of carrying on on the host."""
    from skellysim_tpu_torch.precompute import main

    cfg = schema.ConfigSpherical()
    cfg.periphery.n_nodes = 60
    path = str(tmp_path / "skelly_config.toml")
    cfg.save(path)
    if torch.cuda.is_available():
        stats = main([path])
        assert stats["inverse_residual"] < 1e-4
        with np.load(tmp_path / "periphery_precompute.npz") as z:
            assert z["M_inv"].dtype == np.float32
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([path])
        assert not (tmp_path / "periphery_precompute.npz").exists()


def test_mapped_npz_load_equals_a_read(tmp_path):
    """`builder._load_npz(mapped=True)` (the card's shell build: the
    uncompressed members memory-mapped) gives the arrays a read gives,
    value, shape, dtype and order, scalars and empty members included;
    a compressed npz falls back to the read."""
    rng = np.random.default_rng(4)
    data = {"nodes": rng.standard_normal((50, 3)),
            "M_inv": np.asfortranarray(rng.standard_normal((30, 30))),
            "radius": np.float64(2.5), "empty": np.zeros((0, 3)),
            "ids": np.arange(7, dtype=np.int32)}
    for save in (np.savez, np.savez_compressed):
        path = str(tmp_path / f"{save.__name__}.npz")
        save(path, **data)
        got = tbuilder._load_npz(path, "test", mapped=True)
        assert sorted(got) == sorted(data)
        for k, v in data.items():
            g = np.asarray(got[k])
            assert g.dtype == v.dtype and g.shape == v.shape, k
            assert np.array_equal(g, v), k
            if save is np.savez and v.ndim and v.size:
                assert isinstance(got[k], np.memmap), k
        assert got["M_inv"].flags.f_contiguous
        assert torch.equal(torch.as_tensor(got["M_inv"]).contiguous(),
                           torch.as_tensor(data["M_inv"]).contiguous())
