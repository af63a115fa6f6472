"""The port's precision tiles against the JAX package's: the double-float
("df") sums and the matmul-form ("mxu") tiles, at the pair seam, in a
`System` step and on the ring.

* the error-free transforms are exact (two-sum, Dekker's two-product) and
  the double-float words carry ~2 x 24 bits;
* `stokeslet_direct_df` / `stresslet_direct_df` against the JAX package's
  at 1e-13 relative, float32 and float64 inputs (small JAX tiles keep
  XLA:CPU's compile short; the port sums in its own tile, so the order
  differs);
* the mxu tiles against the JAX package's at 1e-12 in float64 and at its
  float32 test tolerance (tests/test_kernels.py: 1e-2 of the norm
  against the float64 sum);
* ``kernel_impl = "df"`` / ``"mxu"`` steps against the JAX package's at
  1e-10 with equal iterations, and ``refine_pair_impl = "df"`` in
  "mixed" against the port's own "exact" refinement at 1e-10 and the JAX
  package's at its mixed gate;
* the ring's mxu and df tiles against the JAX ring.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.ops import df_kernels as jdf
from skellysim_tpu.ops import kernels as jk
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.parallel import make_mesh as jmake_mesh
from skellysim_tpu.parallel import ring as jring
from skellysim_tpu.system import System as JSystem
from skellysim_tpu.testing import make_coupled_parts as jcoupled_parts
from skellysim_tpu_torch.ops import df_kernels as tdf
from skellysim_tpu_torch.ops import kernels as tk
from skellysim_tpu_torch.parallel import make_mesh, ring
from skellysim_tpu_torch.system import System
from torch_jax_state import port_state, port_system


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cloud(n_src=600, n_trg=250, seed=1, box=None):
    """Sources, targets (the first 80 coincident with sources: their self
    pairs drop), forces and stresslet sources."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n_src, 3)) if box is None
           else rng.uniform(-box, box, (n_src, 3)))
    extra = (rng.standard_normal((n_trg - 80, 3)) if box is None
             else rng.uniform(-box, box, (n_trg - 80, 3)))
    return (pts, np.concatenate([pts[:80], extra]),
            rng.standard_normal((n_src, 3)),
            rng.standard_normal((n_src, 3, 3)))


def test_error_free_transforms_are_exact():
    """two_sum and two_prod return the float64-exact sum and product of
    float32 operands as hi + lo; a DF product of split float64 values is
    good to ~2^-44."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(20000, generator=g, dtype=torch.float32)
    b = torch.randn(20000, generator=g, dtype=torch.float32) * \
        torch.exp2(torch.randint(-30, 30, (20000,), generator=g).float())
    s, e = tdf.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p, e = tdf.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    x = torch.randn(5000, generator=g, dtype=torch.float64)
    y = torch.randn(5000, generator=g, dtype=torch.float64)
    h, l = tdf.df_mul(*tdf.df_split(x), *tdf.df_split(y))
    err = ((h.double() + l.double()) - x * y).abs() / (x * y).abs()
    assert float(err.max()) < 2.0 ** -44
    r = torch.rand(5000, generator=g, dtype=torch.float64) + 0.5
    h, l = tdf.df_rsqrt(*tdf.df_split(r))
    assert float(((h.double() + l.double()) * r.sqrt() - 1).abs().max()) \
        < 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_df_sums_match_jax(family, dtype):
    src, trg, f, S = (a.astype(dtype) for a in _cloud())
    pay = f if family == "stokeslet" else S
    ref = getattr(jdf, f"{family}_direct_df")(
        jnp.asarray(src), jnp.asarray(trg), jnp.asarray(pay), 1.3,
        block_size=64, source_block=256)
    got = getattr(tdf, f"{family}_direct_df")(
        torch.as_tensor(src), torch.as_tensor(trg), torch.as_tensor(pay), 1.3)
    assert got.dtype == torch.float64
    assert _rel(got, ref) < 1e-13
    # the seam casts back to the targets' dtype, as every tier does
    seam = getattr(tk, f"{family}_direct")(
        torch.as_tensor(src), torch.as_tensor(trg), torch.as_tensor(pay), 1.3,
        impl="df")
    assert seam.dtype == torch.as_tensor(trg).dtype
    assert torch.equal(seam, got.to(seam.dtype))


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_mxu_tiles_match_jax(family):
    """tests/test_kernels.py's well-separated clouds: float64 to 1e-12 of
    the JAX tile, and through the chunked path (over 32,768 sources JAX
    chunks by 8,192, each chunk recentered: the port chunks the same);
    float32 within JAX's float32 gate of the float64 sum."""
    if family == "stokeslet":
        rng = np.random.default_rng(31)
        src = trg = rng.uniform(-10, 10, (500, 3))
        pay = rng.standard_normal((500, 3))
    else:
        rng = np.random.default_rng(37)
        src = rng.uniform(-10, 10, (400, 3))
        trg = np.concatenate([src[:100], rng.uniform(-10, 10, (151, 3))])
        pay = rng.standard_normal((400, 3, 3))
    jfn = getattr(jk, f"{family}_direct")
    tfn = getattr(tk, f"{family}_direct")
    ref = jfn(jnp.asarray(src), jnp.asarray(trg), jnp.asarray(pay), 1.4,
              impl="mxu")
    got = tfn(torch.as_tensor(src), torch.as_tensor(trg),
              torch.as_tensor(pay), 1.4, impl="mxu")
    assert _rel(got, ref) < 1e-12
    exact = jfn(jnp.asarray(src), jnp.asarray(trg), jnp.asarray(pay), 1.4)
    got32 = tfn(*(torch.as_tensor(a.astype(np.float32))
                  for a in (src, trg, pay)), 1.4, impl="mxu")
    assert got32.dtype == torch.float32
    assert _rel(got32, exact) < 1e-2
    block = getattr(tk, f"{family}_block_mxu")
    jblock = getattr(jk, f"{family}_block_mxu")
    assert _rel(block(*(torch.as_tensor(a) for a in (trg, src, pay))),
                jblock(*(jnp.asarray(a) for a in (trg, src, pay)))) < 1e-12


def test_mxu_chunks_recenter_like_jax():
    """Above the chunk threshold each 8,192-source chunk recenters on its
    first point in both packages: the sums agree to 1e-12."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-20, 20, (33000, 3))
    trg = rng.uniform(-20, 20, (40, 3))
    f = rng.standard_normal((33000, 3))
    ref = jk.stokeslet_direct(jnp.asarray(src), jnp.asarray(trg),
                              jnp.asarray(f), 1.0, impl="mxu")
    got = tk.stokeslet_direct(torch.as_tensor(src), torch.as_tensor(trg),
                              torch.as_tensor(f), 1.0, impl="mxu")
    assert _rel(got, ref) < 1e-12


@functools.lru_cache(maxsize=1)
def _coupled_parts():
    """The JAX coupled scene's shell and body, built once for the
    module (every step below starts from them)."""
    return jcoupled_parts(120, 80, jnp.float64)


def _coupled_jax(**params):
    shell, shape, bodies = _coupled_parts()
    t = np.linspace(0, 1, 16)
    x = np.array([0.0, 2.5, 0.0]) + t[:, None] * np.array([0.0, 0.0, 1.0])
    fibers = jfc.make_group(x[None], lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125, dtype=jnp.float64)
    jsys = JSystem(JParams(eta=1.0, dt_initial=0.05, gmres_tol=1e-11,
                           adaptive_timestep_flag=False, **params),
                   shell_shape=shape)
    return jsys, jsys.make_state(fibers=fibers, shell=shell, bodies=bodies)


@pytest.mark.parametrize("impl", ["df", "mxu"])
def test_kernel_impl_steps_match_jax(impl):
    """A shell-coupled step with every pair sum on the ``impl`` tile: the
    JAX package's iterations and health, the solution and fiber to
    1e-10."""
    jsys, jstate = _coupled_jax(kernel_impl=impl)
    jn, jsol, ji = jsys.step(jstate)
    tn, tsol, ti = port_system(jsys).step(port_state(jstate))
    assert ti.converged and bool(ji.converged)
    assert ti.iters == int(ji.iters) and ti.health == int(ji.health)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-10 * np.abs(jsol).max())
    np.testing.assert_allclose(tn.fibers.x.numpy(), np.asarray(jn.fibers.x),
                               rtol=0, atol=1e-10)


def test_refine_df_mixed_step():
    """"mixed" with the double-float refinement tile: the same sweeps as
    the port's "exact" refinement and its solution to 1e-10 (the tiles
    differ at ~1e-14 in the f64 residual); against the JAX package's
    "df" refinement at the mixed gate of tests/test_torch_system.py
    (1e-8: the two f32 interiors round differently)."""
    jsys, jstate = _coupled_jax(solver_precision="mixed",
                                refine_pair_impl="df")
    jn, jsol, ji = jsys.step(jstate)
    tsys = port_system(jsys)
    tn, tsol, ti = tsys.step(port_state(jstate))
    assert ti.converged and ti.residual_true <= 1e-11
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-8 * np.abs(jsol).max())
    exact_sys, exact_state = _coupled_jax(solver_precision="mixed",
                                          refine_pair_impl="exact")
    _, esol, ei = port_system(exact_sys).step(port_state(exact_state))
    assert (ti.refines, ti.iters) == (ei.refines, ei.iters)
    np.testing.assert_allclose(tsol.numpy(), esol.numpy(), rtol=0,
                               atol=1e-10 * float(esol.abs().max()))
    with pytest.raises(ValueError, match="kernel_impl"):
        System(tsys.params.__class__(kernel_impl="nope"), device="cpu")


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_mxu_and_df_tiles_match_jax(family):
    """The ring's mxu tile (one centre a rotating shard block) and its
    double-float refine tile on 8 CPU shards against the JAX rings on
    conftest's 8 virtual devices: mxu to 1e-12 and df to 1e-13 of the
    norm."""
    rng = np.random.default_rng(41)
    n = 8 * 16
    r = rng.uniform(-10, 10, (n, 3))
    pay = (rng.standard_normal((n, 3)) if family == "stokeslet"
           else rng.standard_normal((n, 3, 3)))
    jmesh, mesh = jmake_mesh(8), make_mesh(8, device="cpu")
    args_j = (jnp.asarray(r), jnp.asarray(r), jnp.asarray(pay), 1.2)
    args_t = (torch.as_tensor(r), torch.as_tensor(r), torch.as_tensor(pay),
              1.2)
    ref = getattr(jring, f"ring_{family}")(*args_j, mesh=jmesh, impl="mxu")
    got = getattr(ring, f"ring_{family}")(*args_t, mesh=mesh, impl="mxu")
    assert _rel(got, ref) < 1e-12
    ref = getattr(jring, f"ring_{family}_df")(*args_j, mesh=jmesh)
    got = getattr(ring, f"ring_{family}_df")(*args_t, mesh=mesh, impl="df")
    assert got.dtype == torch.float64 and _rel(got, ref) < 1e-13
