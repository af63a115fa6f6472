"""The port's pair kernels (plain versions and the seam) against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays. On the CPU the port's kernel wrappers take their plain
versions (a CUDA kernel has no CPU mode); the kernels themselves are held
against these same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.ops import kernels as jk
from skellysim_tpu.ops.pallas_df import stokeslet_pallas_df, stresslet_pallas_df
from skellysim_tpu.ops.pallas_kernels import stokeslet_pallas, stresslet_pallas
from skellysim_tpu_torch.ops import cuda_kernels, kernels as tk

ETA = 1.3


def _cloud(kind, n_src=700, n_trg=300, seed=0):
    """(r_src, r_trg, f) for one test cloud. Every cloud carries inactive
    zero-weight sources pinned at the origin and targets at the origin and
    on sources (exactly coincident pairs the kernel must drop)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        r_src = rng.uniform(-2.0, 2.0, (n_src, 3))
    elif kind == "clustered":
        centers = rng.uniform(-3.0, 3.0, (6, 3))
        r_src = (centers[rng.integers(0, 6, n_src)]
                 + 1e-2 * rng.standard_normal((n_src, 3)))
    else:  # "coincident": duplicated source points
        base = rng.uniform(-1.0, 1.0, (n_src // 2, 3))
        r_src = np.concatenate([base, base[: n_src - n_src // 2]])
    f = rng.standard_normal((n_src, 3))
    r_src[-10:] = 0.0   # inactive slots: origin-pinned ...
    f[-10:] = 0.0       # ... with zero weight
    r_trg = np.concatenate([r_src[: n_trg // 2],
                            rng.uniform(-2.0, 2.0, (n_trg - n_trg // 2 - 1, 3)),
                            np.zeros((1, 3))])
    return r_src, r_trg, f


def _t(a, dtype):
    return torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_plain_f32_matches_pallas_tile(kind):
    """Plain f32 vs the Pallas f32 tile in interpret mode. Tolerance 1e-5
    of the largest velocity: both sum ~700 f32 terms per target in
    different orders (eps_f32 * sqrt(700) ~ 3e-6)."""
    r_src, r_trg, f = (a.astype(np.float32) for a in _cloud(kind))
    ref = np.asarray(stokeslet_pallas(jnp.asarray(r_src), jnp.asarray(r_trg),
                                      jnp.asarray(f), ETA, interpret=True))
    got = cuda_kernels.stokeslet_f32_plain(
        _t(r_src, torch.float32), _t(r_trg, torch.float32),
        _t(f, torch.float32), ETA).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_plain_f64_matches_exact(kind):
    """Plain f64 vs the JAX exact f64 path: same arithmetic, different
    summation order -> 1e-12 relative."""
    r_src, r_trg, f = _cloud(kind)
    ref = np.asarray(jk.stokeslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(f),
                                         ETA))
    got = cuda_kernels.stokeslet_f64_plain(
        _t(r_src, torch.float64), _t(r_trg, torch.float64),
        _t(f, torch.float64), ETA).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_plain_f64_matches_pallas_df_tile():
    """Plain f64 vs the double-float Pallas tile (interpret mode, one
    128 x 512 tile: interpret-mode DF is slow). The DF tile reaches ~1e-14
    relative, so 1e-12 of the largest velocity."""
    r_src, r_trg, f = _cloud("clustered", n_src=400, n_trg=100, seed=3)
    ref = np.asarray(stokeslet_pallas_df(
        jnp.asarray(r_src), jnp.asarray(r_trg), jnp.asarray(f), ETA,
        interpret=True))
    got = cuda_kernels.stokeslet_f64_plain(
        _t(r_src, torch.float64), _t(r_trg, torch.float64),
        _t(f, torch.float64), ETA).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("impl,dtype", [("exact", torch.float64),
                                        ("pallas", torch.float32),
                                        ("pallas", torch.float64),
                                        ("pallas_df", torch.float32),
                                        ("pallas_df", torch.float64)])
def test_seam_routing_and_dtype_contract(impl, dtype):
    """`stokeslet_direct` returns ``r_trg.dtype`` for every impl (the DF
    contract: an f32 solve never promotes), and on CPU tensors the kernel
    wrappers run their plain versions without counting a launch."""
    r_src, r_trg, f = _cloud("random", n_src=200, n_trg=50)
    before = [w.launches for w in cuda_kernels.KERNEL_WRAPPERS]
    got = tk.stokeslet_direct(_t(r_src, dtype), _t(r_trg, dtype),
                              _t(f, dtype), ETA, impl=impl)
    assert got.dtype == dtype
    assert [w.launches for w in cuda_kernels.KERNEL_WRAPPERS] == before
    ref = np.asarray(jk.stokeslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(f),
                                         ETA))
    tol = 1e-12 if (dtype == torch.float64) else 1e-5
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_pallas_impl_for_and_unported_impls():
    a32 = torch.zeros((2, 3), dtype=torch.float32)
    a64 = torch.zeros((2, 3), dtype=torch.float64)
    assert tk.pallas_impl_for("pallas", a32, a32) == "pallas"
    assert tk.pallas_impl_for("pallas", a32, a64) == "exact"
    assert tk.pallas_impl_for("exact", a64) == "exact"
    # "df" and "mxu" are the JAX package's plain-XLA tiles, plain torch
    # here (tests/test_torch_precision.py holds them against the JAX
    # package's): the seam serves them, in the targets' dtype
    src = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                       dtype=torch.float64)
    f = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    ref = tk.stokeslet_direct(src, src, f, 1.0)
    for impl in ("df", "mxu"):
        got = tk.stokeslet_direct(src, src, f, 1.0, impl=impl)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, ref, rtol=1e-13, atol=0)


def test_oseen_tensor_matches_jax_batched():
    """The batched dense self-mobility blocks vs the JAX per-fiber tensor
    (f64, 1e-13: identical arithmetic up to operation order)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 16, 3))
    x[0, 3] = x[0, 4] + 1e-7  # inside the regularization radius
    got = tk.oseen_tensor(_t(x, torch.float64), _t(x, torch.float64),
                          ETA).numpy()
    for i in range(3):
        ref = np.asarray(jk.oseen_tensor(jnp.asarray(x[i]), jnp.asarray(x[i]),
                                         ETA))
        np.testing.assert_allclose(got[i], ref, rtol=1e-13, atol=1e-13)


def test_point_source_flows_match_jax():
    rng = np.random.default_rng(9)
    src = rng.uniform(-1, 1, (5, 3))
    trg = np.concatenate([src[:2], rng.uniform(-1, 1, (20, 3))])
    dens = rng.standard_normal((5, 3))
    for jfn, tfn in ((jk.oseen_contract, tk.oseen_contract),
                     (jk.rotlet, tk.rotlet)):
        ref = np.asarray(jfn(jnp.asarray(src), jnp.asarray(trg),
                             jnp.asarray(dens), ETA))
        got = tfn(_t(src, torch.float64), _t(trg, torch.float64),
                  _t(dens, torch.float64), ETA).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_kernel_source_and_build_are_not_touched_at_import():
    """The CUDA sources ship in the package; importing the wrappers built
    nothing (a library loads at the first launch on a CUDA tensor)."""
    from skellysim_tpu_torch.ops import cuda_build

    text = "".join((cuda_build.CSRC_DIR / f"{src}.cu").read_text()
                   for src in cuda_kernels.SOURCES)
    for w in cuda_kernels.KERNEL_WRAPPERS:
        assert f"{w.__name__}_launch" in text
    assert "cudaGetLastError" in text
    for tile in ("_stokeslet_kernel", "_stokeslet_df_kernel",
                 "_stresslet_kernel", "_stresslet_df_kernel",
                 "_ring_kernel"):
        assert tile in text  # the source notes name each Pallas tile
    assert not cuda_kernels._libs


def _stresslet_cloud(kind, n_src=700, n_trg=300, seed=0):
    """(r_dl, r_trg, f_dl [n, 3, 3]) with the same point sets as `_cloud`
    (exactly coincident pairs, origin-pinned zero-density sources) and a
    random 9-component source."""
    r_src, r_trg, _ = _cloud(kind, n_src, n_trg, seed)
    rng = np.random.default_rng(seed + 100)
    S = rng.standard_normal((n_src, 3, 3))
    S[-10:] = 0.0
    return r_src, r_trg, S


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_plain_stresslet_f32_matches_pallas_tile(kind):
    """Plain f32 stresslet (kernel C's plain version) vs the Pallas f32
    tile in interpret mode, both on the same f32 inputs. Tolerance 1e-5 of
    the largest velocity: ~700 f32 terms per target summed in different
    orders; coincident pairs must come out finite."""
    r_src, r_trg, S = (a.astype(np.float32) for a in _stresslet_cloud(kind))
    ref = np.asarray(stresslet_pallas(jnp.asarray(r_src), jnp.asarray(r_trg),
                                      jnp.asarray(S), ETA, interpret=True))
    got = cuda_kernels.stresslet_f32_plain(
        _t(r_src, torch.float32), _t(r_trg, torch.float32),
        _t(S, torch.float32), ETA).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_plain_stresslet_f64_matches_exact(kind):
    """Plain f64 stresslet (kernel D's plain version) vs the JAX exact f64
    path: same arithmetic, different summation order -> 1e-12."""
    r_src, r_trg, S = _stresslet_cloud(kind)
    ref = np.asarray(jk.stresslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(S),
                                         ETA))
    got = cuda_kernels.stresslet_f64_plain(
        _t(r_src, torch.float64), _t(r_trg, torch.float64),
        _t(S, torch.float64), ETA).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_plain_stresslet_f64_matches_pallas_df_tile():
    """Plain f64 stresslet vs the double-float Pallas tile (interpret mode,
    one 128 x 512 tile). The DF tile reaches ~1e-14 relative per pair, so
    1e-12 of the largest velocity. The random cloud, not the clustered one:
    at 1e-2 cluster spread the r^-5 pair terms exceed the sums they cancel
    into by ~1e2, which lifts both f64-grade results' error to ~1e-12 of
    max|u|."""
    r_src, r_trg, S = _stresslet_cloud("random", n_src=400, n_trg=100,
                                       seed=3)
    ref = np.asarray(stresslet_pallas_df(
        jnp.asarray(r_src), jnp.asarray(r_trg), jnp.asarray(S), ETA,
        interpret=True))
    got = cuda_kernels.stresslet_f64_plain(
        _t(r_src, torch.float64), _t(r_trg, torch.float64),
        _t(S, torch.float64), ETA).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("impl,dtype", [("exact", torch.float64),
                                        ("pallas", torch.float32),
                                        ("pallas", torch.float64),
                                        ("pallas_df", torch.float32),
                                        ("pallas_df", torch.float64)])
def test_stresslet_seam_routing_and_dtype_contract(impl, dtype):
    """`stresslet_direct` returns ``r_trg.dtype`` for every impl, and on CPU
    tensors the kernel wrappers run their plain versions without counting
    a launch; the unscaled entry (eta=None) carries the -3."""
    r_src, r_trg, S = _stresslet_cloud("random", n_src=200, n_trg=50)
    before = [w.launches for w in cuda_kernels.KERNEL_WRAPPERS]
    got = tk.stresslet_direct(_t(r_src, dtype), _t(r_trg, dtype),
                              _t(S, dtype), ETA, impl=impl)
    assert got.dtype == dtype
    assert [w.launches for w in cuda_kernels.KERNEL_WRAPPERS] == before
    ref = np.asarray(jk.stresslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(S),
                                         ETA))
    tol = 1e-12 if (dtype == torch.float64) else 1e-5
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
    unscaled = cuda_kernels.stresslet_f64(_t(r_src, torch.float64),
                                          _t(r_trg, torch.float64),
                                          _t(S.reshape(-1, 9), torch.float64))
    np.testing.assert_allclose(unscaled.numpy() / (8 * np.pi * ETA), ref,
                               rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def _surface(n=120, seed=4):
    """Points and unit normals of a jittered sphere, with one pair inside
    the reference's regularization radius (eps = 1e-5)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = (1.0 + 0.05 * rng.standard_normal((n, 1))) * u
    r[1] = r[0] + 3e-6
    return r, u


def test_operator_builders_match_jax():
    """`stresslet_times_normal_blocked` (regularized value kept at r = 0,
    diagonal masked by index), `stresslet_times_normal_times_density`
    (r = 0 dropped by value) and `subtract_singularity_columns` vs the JAX
    builders in f64: identical arithmetic up to operation order -> 1e-12
    of the largest entry. A block size that does not divide n checks the
    ragged last block."""
    r, nrm = _surface()
    rng = np.random.default_rng(6)
    dens = rng.standard_normal(r.shape)
    w = rng.uniform(0.5, 1.5, r.shape[0])
    sv = [rng.standard_normal(r.shape) for _ in range(3)]

    M_ref = np.asarray(jk.stresslet_times_normal_blocked(
        jnp.asarray(r), jnp.asarray(nrm), 1.0))
    M = tk.stresslet_times_normal_blocked(_t(r, torch.float64),
                                          _t(nrm, torch.float64), 1.0,
                                          block_size=37)
    np.testing.assert_allclose(M.numpy(), M_ref, rtol=0,
                               atol=1e-12 * np.abs(M_ref).max())

    S_ref = np.asarray(jk.stresslet_times_normal_times_density(
        jnp.asarray(r), jnp.asarray(nrm), jnp.asarray(dens), 1.0))
    S = tk.stresslet_times_normal_times_density(
        _t(r, torch.float64), _t(nrm, torch.float64), _t(dens, torch.float64),
        1.0).numpy()
    np.testing.assert_allclose(S, S_ref, rtol=0,
                               atol=1e-12 * np.abs(S_ref).max())

    sub_ref = np.asarray(jk.subtract_singularity_columns(
        jnp.asarray(M_ref), tuple(jnp.asarray(e) for e in sv),
        jnp.asarray(w)))
    sub = tk.subtract_singularity_columns(
        torch.as_tensor(M_ref.copy()), tuple(_t(e, torch.float64) for e in sv),
        _t(w, torch.float64)).numpy()
    np.testing.assert_allclose(sub, sub_ref, rtol=0, atol=1e-14)
