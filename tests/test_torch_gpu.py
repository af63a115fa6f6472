"""The port on the card, and the port's import discipline.

Tests marked ``gpu`` hold the hand-written CUDA kernels against their plain
versions on the card; they skip where there is no card (whether there is
one is decided inside the fixture, never at import, so every test worker
collects the same tests). Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

The import-discipline test runs everywhere: no module of the port and not
chip_smoke.py imports jax or the JAX package.
"""

import ast
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cloud(n_src, n_trg, dtype, device, seed=0):
    """Fiber-like cloud: sources in a 20-box, targets on sources (exact
    self pairs) and off them, 16 inactive origin-pinned zero-force slots."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, (n_src, 3))
    f = rng.standard_normal((n_src, 3)) / n_src
    src[-16:] = 0.0
    f[-16:] = 0.0
    trg = np.concatenate([src[: n_trg // 2],
                          rng.uniform(-10, 10, (n_trg - n_trg // 2, 3))])
    trg[-1] = 0.0
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (src, trg, f))


def _rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
def test_kernel_a_matches_plain(cuda):
    """Kernel A (f32) vs the plain version in f64 on the same f32 inputs:
    1e-4 of the largest velocity (f32 sums of 2^16 terms)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f = _cloud(1 << 16, 4096, torch.float32, cuda)
    n0 = ck.stokeslet_f32.launches
    got = ck.stokeslet_f32(src, trg, f, 1.3)
    torch.cuda.synchronize()
    assert ck.stokeslet_f32.launches == n0 + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ref = ck.stokeslet_f64_plain(src, trg, f, 1.3)
    assert _rel_err(got, ref) < 1e-4
    unscaled = ck.stokeslet_f32(src, trg, f)
    assert _rel_err(unscaled * (1.0 / (8 * math.pi * 1.3)), ref) < 1e-4


@pytest.mark.gpu
def test_kernel_b_matches_plain(cuda):
    """Kernel B (native FP64) vs the plain f64 version: <= 1e-12."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f = _cloud(1 << 16, 4096, torch.float64, cuda, seed=1)
    n0 = ck.stokeslet_f64.launches
    got = ck.stokeslet_f64(src, trg, f, 0.7)
    torch.cuda.synchronize()
    assert ck.stokeslet_f64.launches == n0 + 1
    assert got.dtype == torch.float64
    ref = ck.stokeslet_f64_plain(src, trg, f, 0.7)
    assert _rel_err(got, ref) <= 1e-12
    # f32 inputs are widened, the output is f64
    got32 = ck.stokeslet_f64(src.float(), trg.float(), f.float(), 0.7)
    assert got32.dtype == torch.float64


@pytest.mark.gpu
def test_self_term_is_exactly_zero(cuda):
    """A lone source seen from its own position contributes exactly 0, and
    a zero-force source at the origin stays finite (select, not multiply)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for fn, dt in ((ck.stokeslet_f32, torch.float32),
                   (ck.stokeslet_f64, torch.float64)):
        src = torch.tensor([[0.5, -0.25, 1.0], [0.0, 0.0, 0.0]], dtype=dt,
                           device=cuda)
        f = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], dtype=dt,
                         device=cuda)
        u = fn(src, src, f, 1.0)
        assert u[0].abs().max().item() == 0.0
        assert torch.isfinite(u).all()


@pytest.mark.gpu
def test_ragged_edges(cuda):
    """Counts that are not tile multiples (bounds checks, no sentinels)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for n_src, n_trg in ((1, 1), (257, 3), (1000, 513)):
        src, trg, f = _cloud(n_src + 16, n_trg, torch.float64, cuda, seed=2)
        got = ck.stokeslet_f64(src, trg, f, 1.0)
        ref = ck.stokeslet_f64_plain(src, trg, f, 1.0)
        assert _rel_err(got, ref) <= 1e-12


def _shell_cloud(n_src, n_trg, dtype, device, seed=0):
    """Shell-like stresslet cloud: sources on a sphere of radius 5 with
    f_dl = 2 n (x) rho, targets inside it, some targets exactly on sources
    (self pairs), and 8 zero-normal sources sharing one position that is
    also a target (r = 0 with zero density)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n_src, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    src = 5.0 * u
    f_dl = 2.0 * (-u)[:, :, None] * rng.standard_normal((n_src, 3))[:, None, :]
    f_dl /= n_src
    src[-8:] = [0.5, -0.25, 1.0]
    f_dl[-8:] = 0.0
    trg = np.concatenate([src[: n_trg // 4],
                          rng.uniform(-3, 3, (n_trg - n_trg // 4, 3))])
    trg[-1] = [0.5, -0.25, 1.0]
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (src, trg, f_dl))


@pytest.mark.gpu
def test_kernel_c_matches_plain(cuda):
    """Kernel C (f32 stresslet) vs the plain version in f64 on the same f32
    inputs: 1e-4 of the largest velocity (f32 sums of 2^13 terms, the
    r^-5 weights amplify rounding near the shell)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f_dl = _shell_cloud(1 << 13, 1 << 14, torch.float32, cuda)
    n0 = ck.stresslet_f32.launches
    got = ck.stresslet_f32(src, trg, f_dl, 1.3)
    torch.cuda.synchronize()
    assert ck.stresslet_f32.launches == n0 + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ref = ck.stresslet_f64_plain(src, trg, f_dl, 1.3)
    assert _rel_err(got, ref) < 1e-4
    unscaled = ck.stresslet_f32(src, trg, f_dl)
    assert _rel_err(unscaled * (1.0 / (8 * math.pi * 1.3)), ref) < 1e-4


@pytest.mark.gpu
def test_kernel_d_matches_plain(cuda):
    """Kernel D (native FP64 stresslet) vs the plain f64 version: <= 1e-12,
    including ragged counts and f32 inputs widened to an f64 output."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for n_src, n_trg in ((1 << 13, 1 << 14), (9, 1), (129, 257)):
        src, trg, f_dl = _shell_cloud(n_src, n_trg, torch.float64, cuda,
                                      seed=n_src)
        n0 = ck.stresslet_f64.launches
        got = ck.stresslet_f64(src, trg, f_dl, 0.7)
        torch.cuda.synchronize()
        assert ck.stresslet_f64.launches == n0 + 1
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        ref = ck.stresslet_f64_plain(src, trg, f_dl, 0.7)
        assert _rel_err(got, ref) <= 1e-12
    got32 = ck.stresslet_f64(src.float(), trg.float(), f_dl.float(), 0.7)
    assert got32.dtype == torch.float64


@pytest.mark.gpu
def test_stresslet_self_and_zero_density_pairs(cuda):
    """A lone source seen from its own position contributes exactly 0, and
    zero-normal sources stacked on a target stay finite (select, not
    multiply), in both kernels."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for fn, dt in ((ck.stresslet_f32, torch.float32),
                   (ck.stresslet_f64, torch.float64)):
        src = torch.tensor([[0.5, -0.25, 1.0], [0.0, 0.0, 0.0],
                            [0.0, 0.0, 0.0]], dtype=dt, device=cuda)
        f_dl = torch.zeros((3, 3, 3), dtype=dt, device=cuda)
        f_dl[0] = torch.arange(9, dtype=dt, device=cuda).reshape(3, 3)
        u = fn(src, src, f_dl, 1.0)
        assert u[0].abs().max().item() == 0.0
        assert torch.isfinite(u).all()


@pytest.mark.gpu
def test_small_run_card_vs_cpu(cuda):
    """One mixed-precision step of a small coupled scene (a 120-node shell
    holding a body with 4 bound fibers, plus 2 free fibers) on the card
    (kernels A-D) agrees with the same step on the CPU (plain versions):
    the stepped fiber nodes and body positions to 1e-8 absolute, the
    solution vector to 1e-8 of its largest entry; and every kernel
    launched on the card."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    out = {}
    for dev in ("cpu", "cuda"):
        p = Params(dt_initial=0.02, gmres_tol=1e-12, solver_precision="mixed",
                   kernel_impl="pallas", refine_pair_impl="pallas_df")
        shell, shape, bodies, fibers = make_coupled_scene(
            shell_n=120, body_n=80, n_bound=4, n_free=2, device=dev,
            precond_dtype=torch.float32)
        system = System(p, shell_shape=shape, device=dev)
        n0 = [w.launches for w in ck.KERNEL_WRAPPERS]
        new, sol, info = system.step(system.make_state(
            fibers=fibers, shell=shell, bodies=bodies))
        assert info.converged
        out[dev] = (new.fibers.x.cpu().numpy(),
                    new.bodies.position.cpu().numpy(), sol.cpu().numpy())
        if dev == "cuda":
            assert all(w.launches > k for w, k in zip(ck.KERNEL_WRAPPERS, n0))
    (x_card, pos_card, sol_card), (x_cpu, pos_cpu, sol_cpu) = (out["cuda"],
                                                               out["cpu"])
    np.testing.assert_allclose(x_card, x_cpu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(pos_card, pos_cpu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol_card, sol_cpu, rtol=0,
                               atol=1e-8 * np.abs(sol_cpu).max())


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """Walk the AST of every port module and chip_smoke.py: no import of
    jax (or jaxlib) and none of the JAX package `skellysim_tpu`."""
    files = sorted((REPO / "skellysim_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "skellysim_tpu"):
                bad.append(f"{os.path.relpath(f, REPO)}: {mod}")
    assert not bad, bad
