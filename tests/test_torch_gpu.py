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
import json
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


#: the gates of kernels A and B against the plain f64 sum, as a share of
#: the largest velocity
_STOKESLET_TOL = {"f32": 1e-4, "f64": 1e-12}
_DT = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stokeslet_ragged_shapes_and_split(cuda, prec):
    """Kernels A / B against the plain f64 sum at counts that are not
    multiples of R x threads (targets) or of the tile and the chunk
    (sources), one target, one source, with the source split off (one
    chunk) and on (several chunks, reduced by the second pass)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    kern = getattr(ck, f"stokeslet_{prec}")
    chunks = set()
    for n_trg, n_src in ((1, 1), (1, 5000), (5000, 1), (1000, 513),
                         (777, 100), (2000, 70000), (4097, 12345)):
        src, trg, f = _cloud(n_src + 16, n_trg, _DT[prec], cuda, seed=n_trg)
        plan = ck.pair_card_plan("stokeslet", cuda, prec, n_trg, n_src + 16)
        chunks.add(min(plan.chunks, 2))
        n0 = kern.launches
        got = kern(src, trg, f, 0.9)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        assert got.dtype == _DT[prec] and torch.isfinite(got).all()
        ref = ck.stokeslet_f64_plain(src, trg, f, 0.9)
        assert _rel_err(got, ref) <= _STOKESLET_TOL[prec], (n_trg, n_src)
    assert chunks == {1, 2}  # the split off and on


@pytest.mark.gpu
def test_stokeslet_coincident_pairs_are_exactly_zero(cuda):
    """A target on top of 5,000 stacked sources (several chunks) gets
    exactly 0 from them in A and B, and a target away from them gets their
    finite sum."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for prec in ("f32", "f64"):
        p = torch.tensor([[0.5, -0.25, 1.0]], dtype=_DT[prec], device=cuda)
        src = p.repeat(5000, 1)
        f = torch.randn((5000, 3), dtype=_DT[prec], device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
        trg = torch.cat([p, p + 1.0])
        assert ck.pair_card_plan("stokeslet", cuda, prec, 2, 5000).chunks > 1
        u = getattr(ck, f"stokeslet_{prec}")(src, trg, f, 1.0)
        assert torch.equal(u[0], torch.zeros_like(u[0]))
        assert torch.isfinite(u).all() and u[1].abs().max() > 0


@pytest.mark.gpu
def test_stokeslet_subnormal_r2_is_dropped_without_inf(cuda):
    """A pair whose r^2 is subnormal (r = 1e-20 in f32, 1e-160 in f64),
    which the flush-to-zero rsqrt would turn into inf, is dropped by the
    select: exactly 0, finite. A pair just above the cut (r^2 normal) is
    summed and finite."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for prec, tiny, near in (("f32", 1e-20, 3e-19), ("f64", 1e-160, 1e-150)):
        dt = _DT[prec]
        src = torch.zeros((1, 3), dtype=dt, device=cuda)
        f = torch.tensor([[1.0, 2.0, 3.0]], dtype=dt, device=cuda)
        trg = torch.tensor([[tiny, 0.0, 0.0], [near, 0.0, 0.0]], dtype=dt,
                           device=cuda)
        u = getattr(ck, f"stokeslet_{prec}")(src, trg, f)
        assert torch.isfinite(u).all()
        assert torch.equal(u[0], torch.zeros_like(u[0]))
        # f + (d.f) d / r^2 = (2, 2, 3) along x, times 1 / r
        want = torch.tensor([2.0, 2.0, 3.0], dtype=torch.float64) / near
        torch.testing.assert_close(u[1].double().cpu(), want, rtol=1e-5,
                                   atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stokeslet_two_launches_same_bits(cuda, prec):
    """The split's partial sums are reduced in chunk order, not by atomics:
    two launches on the same inputs give the same bits."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f = _cloud(50_000, 3000, _DT[prec], cuda, seed=4)
    assert ck.pair_card_plan("stokeslet", cuda, prec, 3000, 50_000).chunks > 1
    kern = getattr(ck, f"stokeslet_{prec}")
    a = kern(src, trg, f, 1.0)
    b = kern(src, trg, f, 1.0)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stokeslet_matches_tiled_yardstick(cuda, prec):
    """The redesigned kernel against the first design (the tiled instance,
    one target a thread) on the same inputs: 1e-4 (A) and 1e-12 (B) of
    the largest velocity. Each wrapper counts its own launch only."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f = _cloud(1 << 16, 10_000, _DT[prec], cuda, seed=5)
    new, old = getattr(ck, f"stokeslet_{prec}"), \
        getattr(ck, f"stokeslet_{prec}_tiled")
    n_new, n_old = new.launches, old.launches
    got, ref = new(src, trg, f, 1.0), old(src, trg, f, 1.0)
    torch.cuda.synchronize()
    assert (new.launches, old.launches) == (n_new + 1, n_old + 1)
    assert _rel_err(got, ref.double()) <= _STOKESLET_TOL[prec]


@pytest.mark.gpu
def test_rsqrt_f64_probe(cuda):
    """Kernel B's reciprocal square root over r^2 from DBL_MIN to 1e300:
    the seed's relative error is below 2^-18, so one third-order step
    (error ~2.5 seed^3) reaches f64 rounding: the result within 4 ulp of
    1/sqrt(x) (taken in f64 on the host). Prints both errors."""
    import json

    from skellysim_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(6)
    x = np.concatenate([10.0 ** rng.uniform(-307.6, 300, 200_000),
                        rng.uniform(1e-10, 1e3, 100_000), [2.2250738585072014e-308]])
    seed, y = ck.rsqrt_f64_probe(torch.as_tensor(x, device=cuda))
    ref = 1.0 / np.sqrt(x)
    seed_err = float(np.abs(seed.cpu().numpy() / ref - 1).max())
    err = float(np.abs(y.cpu().numpy() / ref - 1).max())
    print(json.dumps({"rsqrt_f64_seed_max_rel_err": seed_err,
                      "rsqrt_f64_max_rel_err": err, "values": x.size}))
    assert seed_err < 2.0 ** -18
    assert err <= 4 * np.finfo(np.float64).eps


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


#: the gates of kernels C and D against the plain f64 sum, as a share of
#: the largest velocity
_STRESSLET_TOL = {"f32": 1e-4, "f64": 1e-12}


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stresslet_ragged_shapes_and_split(cuda, prec):
    """Kernels C / D against the plain f64 sum at counts that are not
    multiples of R x threads (targets) or of the tile (sources: the pack's
    pads fill the last one), one target, one source, the body scene's 600,
    with the source split off (one chunk) and on (several, reduced by the
    second pass); scaled and unscaled, the -3 kept in both."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    kern = getattr(ck, f"stresslet_{prec}")
    tol = _STRESSLET_TOL[prec]
    chunks = set()
    for n_trg, n_src in ((1, 1), (1, 5000), (5000, 1), (1000, 513),
                         (777, 100), (600, 600), (2000, 20000),
                         (4097, 12345)):
        src, trg, f_dl = _shell_cloud(n_src + 8, n_trg, _DT[prec], cuda,
                                      seed=n_trg)
        plan = ck.pair_card_plan("stresslet", cuda, prec, n_trg, n_src + 8)
        chunks.add(min(plan.chunks, 2))
        n0 = kern.launches
        got = kern(src, trg, f_dl, 0.9)
        unscaled = kern(src, trg, f_dl)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 2
        assert got.dtype == _DT[prec] and torch.isfinite(got).all()
        ref = ck.stresslet_f64_plain(src, trg, f_dl, 0.9)
        assert _rel_err(got, ref) <= tol, (n_trg, n_src)
        ref = ck.stresslet_f64_plain(src, trg, f_dl)
        assert _rel_err(unscaled, ref) <= tol, (n_trg, n_src)
    assert chunks == {1, 2}  # the split off and on


@pytest.mark.gpu
def test_stresslet_coincident_and_zero_density_pairs_are_exactly_zero(cuda):
    """A target on top of 5,000 stacked sources (several chunks) gets
    exactly 0 from them in C and D, a target away from them their finite
    sum; zero-density sources stacked on a target add exactly 0 and no
    NaN."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for prec in ("f32", "f64"):
        dt = _DT[prec]
        p = torch.tensor([[0.5, -0.25, 1.0]], dtype=dt, device=cuda)
        src = p.repeat(5000, 1)
        f_dl = torch.randn((5000, 3, 3), dtype=dt, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
        trg = torch.cat([p, p + 1.0])
        assert ck.pair_card_plan("stresslet", cuda, prec, 2, 5000).chunks > 1
        kern = getattr(ck, f"stresslet_{prec}")
        u = kern(src, trg, f_dl, 1.0)
        assert torch.equal(u[0], torch.zeros_like(u[0]))
        assert torch.isfinite(u).all() and u[1].abs().max() > 0
        f_dl[:] = 0.0
        u = kern(src, trg, f_dl, 1.0)
        assert torch.equal(u, torch.zeros_like(u))


@pytest.mark.gpu
def test_stresslet_subnormal_r2_is_dropped_without_inf(cuda):
    """A pair whose r^2 is subnormal (r = 1e-20 in f32, 1e-160 in f64),
    which the flush-to-zero rsqrt would turn into inf, is dropped: exactly
    0, finite. A close pair whose r^-5 still fits the dtype (r = 1e-6,
    1e-60) is summed: -3 Sxx / r^2 along d = (r, 0, 0), unscaled."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    for prec, tiny, near in (("f32", 1e-20, 1e-6), ("f64", 1e-160, 1e-60)):
        dt = _DT[prec]
        src = torch.zeros((1, 3), dtype=dt, device=cuda)
        f_dl = torch.arange(1.0, 10.0, dtype=dt, device=cuda).reshape(1, 3, 3)
        trg = torch.tensor([[tiny, 0.0, 0.0], [near, 0.0, 0.0]], dtype=dt,
                           device=cuda)
        u = getattr(ck, f"stresslet_{prec}")(src, trg, f_dl)
        assert torch.isfinite(u).all()
        assert torch.equal(u[0], torch.zeros_like(u[0]))
        want = torch.tensor([-3.0 / near ** 2, 0.0, 0.0], dtype=torch.float64)
        torch.testing.assert_close(u[1].double().cpu(), want, rtol=1e-5,
                                   atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stresslet_two_launches_same_bits(cuda, prec):
    """C's and D's partial sums are reduced in chunk order, not by atomics:
    two launches on the same inputs give the same bits."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f_dl = _shell_cloud(20_000, 3000, _DT[prec], cuda, seed=4)
    assert ck.pair_card_plan("stresslet", cuda, prec, 3000,
                             20_000).chunks > 1
    kern = getattr(ck, f"stresslet_{prec}")
    assert torch.equal(kern(src, trg, f_dl, 1.0), kern(src, trg, f_dl, 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_stresslet_matches_tiled_yardstick(cuda, prec):
    """The redesigned C / D against their first design (the tiled instance,
    one target a thread) on the same inputs: 1e-4 (C) and 1e-12 (D) of the
    largest velocity, scaled and unscaled. Each wrapper counts its own
    launches only."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f_dl = _shell_cloud(1 << 13, 10_000, _DT[prec], cuda, seed=5)
    new, old = getattr(ck, f"stresslet_{prec}"), \
        getattr(ck, f"stresslet_{prec}_tiled")
    n_new, n_old = new.launches, old.launches
    for eta in (0.8, None):
        got, ref = new(src, trg, f_dl, eta), old(src, trg, f_dl, eta)
        assert _rel_err(got, ref.double()) <= _STRESSLET_TOL[prec]
    torch.cuda.synchronize()
    assert (new.launches, old.launches) == (n_new + 2, n_old + 2)


@pytest.mark.gpu
def test_stresslet_refuses_an_unbuilt_r(cuda, monkeypatch):
    """A plan with another R than the source's kR raises at the launch
    (cudaErrorInvalidValue, nothing launched) and counts no launch."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    src, trg, f_dl = _shell_cloud(300, 200, torch.float32, cuda, seed=6)
    for prec in ("f32", "f64"):
        kern = getattr(ck, f"stresslet_{prec}")
        kern(src, trg, f_dl)  # loads the library at the built R
        n0 = kern.launches
        monkeypatch.setitem(ck.STRESSLET_R, prec, 2 * ck.STRESSLET_R[prec])
        with pytest.raises(RuntimeError, match="launch failed"):
            kern(src, trg, f_dl)
        assert kern.launches == n0
        monkeypatch.undo()


def _member_batch(family, prec, members, n_src, n_trg, device):
    """B members of one shape, each its own cloud (`_cloud` /
    `_shell_cloud`, a seed a member)."""
    make = _cloud if family == "stokeslet" else _shell_cloud
    clouds = [make(n_src, n_trg, _DT[prec], device, seed=10 + m)
              for m in range(members)]
    return tuple(torch.stack(a) for a in zip(*clouds))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_member_batched_kernels_match_lone_and_plain(cuda, family, prec):
    """A-D over a member axis: one launch for B members; each member equals
    the lone launch bit for bit at the lone plan's chunks, the plain f64
    sum at the tolerance of the lone tests (1e-4 f32, 1e-12 f64) whatever
    the batched plan, and two launches give the same bits. Sources whose
    count is not a multiple of 4 (the padded member stride) included; the
    lone wrapper counts no launch, the batched one one a call."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    lone = getattr(ck, f"{family}_{prec}")
    batched = getattr(ck, f"{family}_{prec}_batched")
    plain64 = getattr(ck, f"{family}_f64_plain")
    tol = (_STOKESLET_TOL if family == "stokeslet" else _STRESSLET_TOL)[prec]
    for members, n_src, n_trg in ((8, 3001, 2000), (3, 600, 17),
                                  (2, 20000, 700)):
        src, trg, pay = _member_batch(family, prec, members, n_src, n_trg,
                                      cuda)
        plan = ck.pair_card_plan(family, cuda, prec, n_trg, n_src, members)
        lone_plan = ck.pair_card_plan(family, cuda, prec, n_trg, n_src)
        n_lone, n_b = lone.launches, batched.launches
        got = batched(src, trg, pay, 0.7)
        again = batched(src, trg, pay, 0.7)
        forced = batched(src, trg, pay, 0.7, chunks=lone_plan.chunks)
        torch.cuda.synchronize()
        assert (lone.launches, batched.launches) == (n_lone, n_b + 3)
        assert got.shape == (members, n_trg, 3) and got.dtype == _DT[prec]
        assert torch.equal(got, again)
        assert plan.members == members
        for m in range(members):
            solo = lone(src[m], trg[m], pay[m], 0.7)
            assert torch.equal(forced[m], solo), (members, n_src, m)
            ref = plain64(src[m], trg[m], pay[m], 0.7)
            assert _rel_err(got[m], ref) <= tol, (members, n_src, m)


@pytest.mark.gpu
def test_member_batched_plan_fills_the_card(cuda):
    """The batched plan splits the sources for B x n_trg targets: eight
    members of 2,000 targets take fewer chunks than one, at least as busy,
    and the scratch grows as [B, chunks, n_trg, 3]."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    one = ck.pair_card_plan("stokeslet", cuda, "f32", 2000, 20000)
    eight = ck.pair_card_plan("stokeslet", cuda, "f32", 2000, 20000, 8)
    assert eight.chunks <= one.chunks and eight.busy >= one.busy - 1e-12
    assert eight.scratch_shape == (8, eight.chunks, 2000, 3)
    assert eight.grid == (one.target_blocks, eight.chunks, 8)


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
            # the direct evaluator's kernels A-D (the ring kernels E / F
            # serve ring runs only)
            direct = (ck.stokeslet_f32, ck.stokeslet_f64, ck.stresslet_f32,
                      ck.stresslet_f64)
            assert all(w.launches > k for w, k in zip(ck.KERNEL_WRAPPERS, n0)
                       if w in direct)
    (x_card, pos_card, sol_card), (x_cpu, pos_cpu, sol_cpu) = (out["cuda"],
                                                               out["cpu"])
    np.testing.assert_allclose(x_card, x_cpu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(pos_card, pos_cpu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol_card, sol_cpu, rtol=0,
                               atol=1e-8 * np.abs(sol_cpu).max())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["mixed", "full"])
def test_poisoned_state_reaches_the_nonfinite_verdict(cuda, precision):
    """A NaN-poisoned state steps on the card to the nonfinite health
    verdict (the fiber and body LU factors take no pivot check, as the
    JAX package's never raise) instead of raising in `lu_factor`; the
    service's quarantine and the chaos smoke stand on it."""
    from skellysim_tpu_torch.guard import chaos, verdict
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    shell, shape, bodies, fibers = make_coupled_scene(
        shell_n=120, body_n=80, n_bound=4, n_free=2, device="cuda",
        precond_dtype=torch.float32 if precision == "mixed" else None)
    system = System(Params(dt_initial=0.02, gmres_tol=1e-10,
                           solver_precision=precision),
                    shell_shape=shape, device="cuda")
    state = chaos.poison_state(system.make_state(fibers=fibers, shell=shell,
                                                 bodies=bodies))
    _, _, info = system.step(state)
    assert info.health & verdict.NONFINITE


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["mixed", "full"])
def test_spmd_step_on_two_shards_matches_step(cuda, precision):
    """`System.step_spmd` on 2 shards of the card against `System.step`
    from the same state, for the small coupled scene (a 120-node shell
    split node-aligned, a body with 4 bound fibers, 2 free fibers): true
    residuals within 5e-9, the stepped fibers and the body within 1e-6;
    the body's fields the same bits on both shards; "mixed" launches E / F
    (the f32 ring), A / C (the replicated rows' partials) and B / D (the
    f64 refinement flows), "full" B / D."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.parallel import (gather_state, make_mesh,
                                              shard_state)
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    p = Params(dt_initial=0.02, gmres_tol=1e-10, solver_precision=precision,
               kernel_impl="pallas", refine_pair_impl="pallas_df")
    shell, shape, bodies, fibers = make_coupled_scene(
        shell_n=120, body_n=80, n_bound=4, n_free=2, device="cuda",
        precond_dtype=torch.float32 if precision == "mixed" else None)
    system = System(p, shell_shape=shape, device="cuda")
    state = system.make_state(fibers=fibers, shell=shell, bodies=bodies)
    ref, _, info_ref = system.step(state)
    mesh = make_mesh(2, device="cuda")
    n0 = {w.__name__: w.launches for w in ck.KERNEL_WRAPPERS}
    new, _, info = system.step_spmd(shard_state(state, mesh), mesh)
    ran = {w.__name__: w.launches - n0[w.__name__]
           for w in ck.KERNEL_WRAPPERS}
    assert info.converged and info_ref.converged and info.health == 0
    assert abs(info.residual_true - info_ref.residual_true) <= 5e-9
    got = gather_state(new)
    assert float((got.fibers.x - ref.fibers.x).abs().max()) <= 1e-6
    assert float((got.bodies.position - ref.bodies.position).abs().max()
                 ) <= 1e-6
    b0, b1 = (st.bodies for st in new.shards)
    assert all(torch.equal(getattr(b0, f), getattr(b1, f))
               for f in b0._fields if torch.is_tensor(getattr(b0, f)))
    need = (["ring_stokeslet_f32", "ring_stresslet_f32", "stokeslet_f32",
             "stresslet_f32", "stokeslet_f64", "stresslet_f64"]
            if precision == "mixed" else ["stokeslet_f64", "stresslet_f64"])
    assert all(ran[k] > 0 for k in need), ran


def _ring_inputs(family, n_dev, nt, ns, device, seed=0):
    """Per-shard f32 lists (targets, sources, payload) of a ring: sources
    in a 10-box, and the first targets of every shard placed exactly on the
    right neighbour's first sources (self pairs across shards)."""
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


def _ring_err(got, ref):
    got, ref = torch.cat(got).double(), torch.cat(ref).double()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_kernel_matches_plain(cuda, family, n_dev):
    """Kernels E / F with n_dev shards on one card (one launch) against
    their plain version (the ring accumulation over kernel A's / C's plain
    block) and against kernel A / C on the whole arrays, at ragged counts
    (targets and sources not tile multiples) with self pairs across
    shards: 1e-4 of the largest velocity, finite everywhere."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    ring = getattr(ck, f"ring_{family}_f32")
    plain = getattr(ck, f"ring_{family}_f32_plain")
    direct = getattr(ck, f"{family}_f32")
    for nt, ns in ((333, 517), (1, 1), (129, 1000)):
        trg, src, pay = _ring_inputs(family, n_dev, nt, ns, cuda,
                                     seed=nt + n_dev)
        n0 = ring.launches
        got = ring(trg, src, pay)
        torch.cuda.synchronize()
        assert ring.launches == n0 + 1
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                   for g in got)
        assert _ring_err(got, plain(trg, src, pay)) < 1e-4
        whole = direct(torch.cat(src), torch.cat(trg), torch.cat(pay))
        assert _ring_err(got, list(whole.split(nt))) < 1e-4


@pytest.mark.gpu
def test_ring_kernel_self_pairs_are_exactly_zero(cuda):
    """A source seen from the target that sits on it in ANOTHER shard
    contributes exactly 0 (the select): with two shards whose one target
    each sits on the other shard's one source, each shard's flow is the
    lone pair of its own source (kernel A / C on that pair, to f32
    rounding); and
    zero-payload sources stacked on the targets give exactly 0, finite."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    p = torch.tensor([[0.5, -0.25, 1.0]], device=cuda)
    q = torch.tensor([[-1.0, 2.0, 0.0]], device=cuda)
    for family, cols in (("stokeslet", 3), ("stresslet", 9)):
        ring = getattr(ck, f"ring_{family}_f32")
        lone = getattr(ck, f"{family}_f32")
        w = torch.arange(1, cols + 1, dtype=torch.float32,
                         device=cuda)[None, :]
        out = ring([q, p], [p, q], [w, 2 * w])
        torch.testing.assert_close(out[0], lone(p, q, w), rtol=1e-6, atol=0)
        torch.testing.assert_close(out[1], lone(q, p, 2 * w), rtol=1e-6,
                                   atol=0)
        out = ring([p, p], [p, p], [0 * w, 0 * w])
        torch.cuda.synchronize()
        assert all(torch.equal(o, torch.zeros_like(o)) for o in out)


@pytest.mark.gpu
def test_ring_kernels_back_to_back(cuda):
    """E, F, E with no host sync between them (one ring's epoch counters
    and barriers carried across instances, another ring's launch between):
    each call gives the results of a lone call, bit for bit."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    e_in = _ring_inputs("stokeslet", 4, 2000, 3000, cuda, seed=1)
    f_in = _ring_inputs("stresslet", 4, 5000, 500, cuda, seed=2)
    e_ref = ck.ring_stokeslet_f32(*e_in)
    f_ref = ck.ring_stresslet_f32(*f_in)
    torch.cuda.synchronize()
    e1 = ck.ring_stokeslet_f32(*e_in)
    f1 = ck.ring_stresslet_f32(*f_in)
    e2 = ck.ring_stokeslet_f32(*e_in)
    torch.cuda.synchronize()
    for got, ref in ((e1, e_ref), (f1, f_ref), (e2, e_ref)):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
def test_ring_kernels_across_cards(cuda):
    """With one shard per card (2 to 4 cards, peer stores over NVLink) E
    and F give the one-card results of the same shards bit for bit (both
    layouts split a step's sources alike), and a
    mixed-precision ring step of a small fiber scene on the card mesh
    gives the one-card mesh's solution. Prints the times of both layouts
    at the full-width shapes (640,000 fiber nodes for E; 8,000 shell nodes
    x 128,000 fiber nodes for F). Skips with fewer than 2 cards."""
    import json
    import time

    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.parallel import make_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs >= 2 cards, {n_cards} visible")
    n = min(4, n_cards)
    cards = make_mesh(n)
    assert cards.devices == tuple(torch.device("cuda", i) for i in range(n))
    times = {"cards": n, "card": torch.cuda.get_device_name(0)}
    for family, nt, ns in (("stokeslet", 640_000 // n, 640_000 // n),
                           ("stresslet", 128_000 // n, 8_000 // n)):
        kern = getattr(ck, f"ring_{family}_f32")
        one = _ring_inputs(family, n, nt, ns, cuda, seed=5)
        spread = [[b.to(d) for b, d in zip(lst, cards.devices)] for lst in one]
        plans = [ck.ring_card_plan(family, [t.device for t in args[0]], nt,
                                   ns) for args in (one, spread)]
        assert plans[0].chunk_tiles == plans[1].chunk_tiles
        for layout, args in (("one card", one), (f"{n} cards", spread)):
            n0 = kern.launches
            kern(*args)                                   # warm-up
            for d in set(cards.devices):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(3):
                out = kern(*args)
            for d in set(cards.devices):
                torch.cuda.synchronize(d)
            times[f"{family} {layout} ms"] = (time.perf_counter() - t0) / 3e-3
            assert kern.launches - n0 == 4 * (1 if layout == "one card" else n)
            if layout == "one card":
                ref = out
            else:
                assert all(o.device == d for o, d in zip(out, cards.devices))
                got = [o.to(cuda) for o in out]
                assert all(torch.equal(g, r) for g, r in zip(got, ref))

    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System

    rng = np.random.default_rng(5)
    t = np.linspace(0, 1, 16)
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = rng.uniform(-4, 4, (4 * n, 3))[:, None, :] + t[None, :, None] * d[:, None]
    sols = []
    for mesh in (make_mesh(n, device=cuda), cards):
        system = System(Params(dt_initial=1e-3, gmres_tol=1e-10,
                               solver_precision="mixed", kernel_impl="pallas",
                               refine_pair_impl="pallas_df",
                               pair_evaluator="ring"), device=cuda, mesh=mesh)
        g = fc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                          radius=0.0125, device=cuda)
        n0 = ck.ring_stokeslet_f32.launches
        _, sol, info = system.step(system.make_state(fibers=g))
        assert info.converged and ck.ring_stokeslet_f32.launches > n0
        sols.append(sol)
    torch.testing.assert_close(sols[1], sols[0], rtol=0,
                               atol=1e-12 * float(sols[0].abs().max()))
    print(json.dumps(times))


@pytest.mark.gpu
def test_member_mesh_across_cards(cuda):
    """Eight members of a small free-fiber ensemble (16 curved 16-node
    fibers each, in a background flow, "full" f64) on a member mesh of one
    shard a card (2 to 4 cards: `make_member_mesh(n)`) step two rounds to
    the one-card round's iterations, accept flags and times, and to its
    fibers bit for bit where each shard's lanes take the one-card
    member-batched plans, else within 1e-11; in "unroll" bit for bit.
    Prints the rounds' walls. Skips with fewer than 2 cards."""
    import json
    import time

    from skellysim_tpu_torch.ensemble import EnsembleRunner
    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.parallel import (gather_ensemble,
                                              make_member_mesh,
                                              shard_ensemble)
    from skellysim_tpu_torch.system import BackgroundFlow, System

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs >= 2 cards, {n_cards} visible")
    n = min(4, n_cards)
    mesh = make_member_mesh(n)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    system = System(Params(dt_initial=1e-3, gmres_tol=1e-10,
                           solver_precision="full",
                           adaptive_timestep_flag=False), device=cuda)
    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, 16)
    states = []
    for m in range(8):
        d = rng.normal(size=(16, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        x = (rng.uniform(-3, 3, (16, 3))[:, None, :]
             + t[None, :, None] * d[:, None] + 0.05 * m)
        x[:, :, 2] += 0.2 * np.sin(3 * t)[None, :]
        g = fc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                          radius=0.0125, force_scale=-0.05, device=cuda)
        states.append(system.make_state(fibers=g, background=(
            BackgroundFlow.make(uniform=(1.0, 0.0, 0.0), device=cuda))))
    import subprocess

    times = {"cards": n, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()}
    for impl in ("vmap", "unroll"):
        runner = EnsembleRunner(system, batch_impl=impl)
        one = runner.make_ensemble(states, [1.0] * 8)
        sh = shard_ensemble(one, mesh)
        assert [p.states.fibers.x.device for p in sh.parts] == list(
            mesh.devices)
        for r in range(2):
            t0 = time.perf_counter()
            one, oinfo = runner.step(one)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sh, sinfo = runner.step(sh)
            for d in mesh.devices:
                torch.cuda.synchronize(d)
            t2 = time.perf_counter()
            times[f"{impl} round {r} one card s"] = t1 - t0
            times[f"{impl} round {r} {n} cards s"] = t2 - t1
            np.testing.assert_array_equal(sinfo.iters, oinfo.iters)
            np.testing.assert_array_equal(sinfo.accepted, oinfo.accepted)
            got = gather_ensemble(sh, cuda)
            np.testing.assert_array_equal(got.states.time, one.states.time)
            dx = float((got.states.fibers.x - one.states.fibers.x
                        ).abs().max())
            times[f"{impl} round {r} max dx"] = dx
            if impl == "unroll":
                assert dx == 0.0
            assert dx <= 1e-11
    print(json.dumps(times))


@pytest.mark.gpu
def test_ring_created_while_a_card_is_busy(cuda):
    """A new ring zeroes each card's counters on that card's own stream.
    Created while the second card's stream is still busy (a sleep kernel
    of about a second queued there), a two-card ring still gives the
    one-card results bit for bit: no card's zero fill lands after its
    neighbour's first signal (which would leave the ring waiting until its
    timeout traps). Skips with fewer than 2 cards."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.parallel import make_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs >= 2 cards, {n_cards} visible")
    cards = make_mesh(2)
    ns = 777                      # a source count no other test's ring uses
    one = _ring_inputs("stokeslet", 2, 301, ns, cuda, seed=9)
    ref = ck.ring_stokeslet_f32(*one)
    spread = [[b.to(d) for b, d in zip(lst, cards.devices)] for lst in one]
    for d in cards.devices:
        torch.cuda.synchronize(d)
    assert ("stokeslet", cards.devices, ns) not in ck._ring_comms
    with torch.cuda.device(cards.devices[1]):
        torch.cuda._sleep(2_000_000_000)
    out = ck.ring_stokeslet_f32(*spread)
    for d in cards.devices:
        torch.cuda.synchronize(d)
    assert ("stokeslet", cards.devices, ns) in ck._ring_comms
    assert all(torch.equal(o.to(cuda), r) for o, r in zip(out, ref))


@pytest.mark.gpu
def test_ring_and_step_across_processes(cuda, tmp_path):
    """Four processes, one a card, joined over `nccl`
    (`parallel.multihost`; the worker is `tests/torch_multihost_worker.py`,
    case "cards"), against one process driving the four cards: kernels E
    and F ring across the processes through CUDA IPC mappings of each
    shard's slots and counters and give the one-process card mesh's bits at
    their full-width shapes (640,000 fiber nodes; 8,000 shell nodes x
    128,000), one launch a process a call; a "mixed" (E / F across the
    processes, B / D a hop by NCCL send / receive) and a "full"
    `System.step_spmd` of 2,000 arcs x 64 nodes in a 2,000-node shell land
    within 5e-9 (true residual; __graft_entry__.py:83 PARITY_GATE) and
    1e-6 (fibers) of the one-process steps, with the same iterations in
    every process. Prints one JSON line of times. Skips below 4 cards."""
    import json
    import sys

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        pytest.skip(f"needs >= 4 cards, {n_cards} visible")
    sys.path.insert(0, str(REPO / "tests"))
    import torch_multihost_worker as w

    from skellysim_tpu_torch.testing import free_port, run_all

    # host threads a process (the four share the host's cores)
    env = w.worker_env(OMP_NUM_THREADS="8", MKL_NUM_THREADS="8")
    one_dir, spread_dir = tmp_path / "one", tmp_path / "spread"
    one_dir.mkdir()
    spread_dir.mkdir()
    run_all([([sys.executable, w.__file__, "cards", "0", "0", "1",
                 str(one_dir)], env, str(REPO))], tmp_path, "one", 600)
    port = free_port()
    run_all([([sys.executable, w.__file__, "cards", str(port), str(rank),
                 "4", str(spread_dir)], env, str(REPO))
               for rank in range(4)], tmp_path, "cards", 600)
    one = torch.load(one_dir / "cards_0.pt", weights_only=False)
    recs = [torch.load(spread_dir / f"cards_{r}.pt", weights_only=False)
            for r in range(4)]
    times = {"card": torch.cuda.get_device_name(0), "processes": 4}
    for family, _, _ in w.CARD_RINGS:
        assert one[f"{family}_launches"] == 4 * 4
        times[f"{family} one process ms"] = one[f"{family}_ms"]
        times[f"{family} 4 processes ms"] = [r[f"{family}_ms"] for r in recs]
        for rank, rec in enumerate(recs):
            assert rec[f"{family}_launches"] == 4
            assert list(rec[family]) == [rank]
            assert torch.equal(rec[family][rank], one[family][rank]), family
    for precision in ("mixed", "full"):
        ref = one[precision]
        assert ref["converged"]
        gaps = []
        for rec in recs:
            got = rec[precision]
            assert got["converged"] and got["iters"] == recs[0][precision][
                "iters"]
            assert abs(got["residual_true"] - ref["residual_true"]) <= 5e-9
            dx = float((got["x"] - ref["x"]).abs().max())
            assert dx <= 1e-6
            gaps.append(dx)
        times[f"{precision} step s"] = {
            "one process": ref["wall_s"],
            "4 processes": [r[precision]["wall_s"] for r in recs],
            "iters": [ref["iters"], recs[0][precision]["iters"]],
            "max |dx|": max(gaps),
            "launches a process": recs[0][precision]["launches"]}
    assert recs[0]["mixed"]["launches"].get("ring_stokeslet_f32", 0) > 0
    assert recs[0]["mixed"]["launches"].get("ring_stresslet_f32", 0) > 0
    print(json.dumps(times))


@pytest.mark.gpu
def test_ring_launch_failure_keeps_the_ring_and_recovers(cuda, monkeypatch):
    """A launch the card refuses (a cooperative grid too wide to be
    resident) raises and counts no launch; the failed ring's buffers stay
    referenced (another card's launch of that call could still write
    them), and the next call starts a fresh ring that gives the lone
    call's sums bit for bit."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    ns = 313                      # a source count no other test's ring uses
    args = _ring_inputs("stresslet", 3, 200, ns, cuda, seed=4)
    ref = ck.ring_stresslet_f32(*args)
    torch.cuda.synchronize()
    key = next(k for k in ck._ring_comms if k[0] == "stresslet" and k[2] == ns)
    comm = ck._ring_comms[key]
    lib = ck._library(ck.RING_SOURCE)
    real = lib.ring_stresslet_f32_launch

    def too_wide(table, n, nt, ns_, first, count, grid, *rest):
        return real(table, n, nt, ns_, first, count, 1 << 20, *rest)

    monkeypatch.setattr(lib, "ring_stresslet_f32_launch", too_wide)
    n0 = ck.ring_stresslet_f32.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.ring_stresslet_f32(*args)
    assert ck.ring_stresslet_f32.launches == n0
    assert key not in ck._ring_comms
    assert any(c is comm for c in ck._failed_rings)
    monkeypatch.undo()
    got = ck.ring_stresslet_f32(*args)
    torch.cuda.synchronize()
    assert ck._ring_comms[key] is not comm
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_redesign_matches_plain_and_first_design(cuda, family):
    """Kernels E / F against their plain version and against their first
    design (the `_v1` yardstick, one target a thread) at ragged shapes
    (targets and sources not multiples of the tile or of R x 128, one pair,
    the source split off and on), with self pairs across shards: 1e-4 of
    the largest velocity; two launches give the same bits; each wrapper
    counts its own launches only."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    ring = getattr(ck, f"ring_{family}_f32")
    old = getattr(ck, f"ring_{family}_f32_v1")
    plain = getattr(ck, f"ring_{family}_f32_plain")
    chunks = set()
    for n_dev, nt, ns in ((4, 333, 517), (3, 1025, 129), (2, 1, 1),
                          (4, 5000, 3000)):
        trg, src, pay = _ring_inputs(family, n_dev, nt, ns, cuda,
                                     seed=nt + ns)
        plan = ck.ring_card_plan(family, [t.device for t in trg], nt, ns)
        chunks.add(min(plan.chunks, 2))
        n_new, n_old = ring.launches, old.launches
        got, again = ring(trg, src, pay), ring(trg, src, pay)
        first = old(trg, src, pay)
        torch.cuda.synchronize()
        assert (ring.launches, old.launches) == (n_new + 2, n_old + 1)
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                   for g in got)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _ring_err(got, plain(trg, src, pay)) < 1e-4, (n_dev, nt, ns)
        assert _ring_err(got, first) < 1e-4, (n_dev, nt, ns)
    assert chunks == {1, 2}  # the split off and on


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_slots_hold_the_plain_layout(cuda, family):
    """After a call every slot of every shard holds, bit for bit, the plain
    tile-major layout (`ring_slot_plain`: positions, then payload, the last
    tile padded at RING_PAD_POSITION with zero payload) of the source block
    the ring order puts there: shard (k - s) mod n in shard k's slot s."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    n, ns = 3, 300
    trg, src, pay = _ring_inputs(family, n, 200, ns, cuda, seed=8)
    getattr(ck, f"ring_{family}_f32")(trg, src, pay)
    torch.cuda.synchronize()
    comm = ck._ring_comms[(family, tuple(t.device for t in trg), ns)]
    for k in range(n):
        slots = comm.slots[k].reshape(n, -1)
        for s in range(n):
            want = ck.ring_slot_plain(family, src[(k - s) % n],
                                      pay[(k - s) % n]).reshape(-1)
            assert torch.equal(slots[s], want), (k, s)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_subnormal_r2_and_coincident_pairs_are_dropped(cuda, family):
    """Kernels E / F on two shards whose sources sit at the origin: a
    target at r = 1e-20 (r^2 subnormal, which the flush-to-zero rsqrt
    would turn into inf) and a target on the origin get exactly 0, finite;
    a target away from them gets their finite sum (for E also one just
    above the cut, r^2 normal, summed to f32 rounding)."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    cols = 3 if family == "stokeslet" else 9
    w = torch.arange(1, cols + 1, dtype=torch.float32, device=cuda)[None, :]
    origin = torch.zeros((1, 3), device=cuda)
    trg = [torch.tensor([[1e-20, 0.0, 0.0], [0.0, 0.0, 0.0]], device=cuda),
           torch.tensor([[5.0, 0.0, 0.0], [3e-19, 0.0, 0.0]], device=cuda)]
    u = getattr(ck, f"ring_{family}_f32")(trg, [origin, origin], [w, 2 * w])
    torch.cuda.synchronize()
    assert torch.isfinite(u[0]).all() and torch.isfinite(u[1][0]).all()
    assert torch.equal(u[0], torch.zeros_like(u[0]))
    lone = getattr(ck, f"{family}_f32")(origin, trg[1][:1], 3 * w)
    torch.testing.assert_close(u[1][:1], lone, rtol=1e-6, atol=0)
    if family == "stokeslet":
        # f + (d.f) d / r^2 = (6, 6, 9) along x for f = (3, 6, 9), times 1 / r
        want = torch.tensor([6.0, 6.0, 9.0], dtype=torch.float64) / 3e-19
        torch.testing.assert_close(u[1][1].double().cpu(), want, rtol=1e-5,
                                   atol=0)


@pytest.mark.gpu
def test_ring_refuses_an_unbuilt_r_or_grid(cuda, monkeypatch):
    """A plan the built instance cannot serve raises and counts no launch:
    another R than the source's kR (the wrapper), and a grid of 0 or another
    R handed to the launcher itself (cudaErrorInvalidValue, nothing
    launched); and a ring whose plan asks for another grid width than the
    ring's counters count raises before anything launches."""
    import ctypes
    import dataclasses

    from skellysim_tpu_torch.ops import cuda_kernels as ck

    lib = ck._library(ck.RING_SOURCE)   # loaded (and checked) at the real R
    other = 8 if ck.RING_R == 4 else 4
    args = _ring_inputs("stokeslet", 2, 100, 211, cuda, seed=3)
    real = ck.ring_card_plan
    n0 = ck.ring_stokeslet_f32.launches
    for change, match in (({"r": other}, "launch failed"),
                          ({"grid": 1}, "grid never changes")):
        monkeypatch.setattr(ck, "ring_card_plan", lambda *a, **k: (
            dataclasses.replace(real(*a, **k), **change)))
        with pytest.raises(RuntimeError, match=match):
            ck.ring_stokeslet_f32(*args)
        assert ck.ring_stokeslet_f32.launches == n0
        monkeypatch.undo()
        if "r" in change:            # a working ring for the grid's case
            ck.ring_stokeslet_f32(*args)
            n0 += 1
    table = (ctypes.c_ulonglong * 14)()
    for grid, r in ((0, ck.RING_R), (4, other)):
        rc = lib.ring_stokeslet_f32_launch(table, 2, 100, 211, 0, 2, grid, 1,
                                           r, 2, 1, 2, 1, None)
        assert rc != 0, (grid, r)


def _tree_cloud(kind, seed=0):
    """A treecode scene on the host: "boundary", fiber segments of a 4-box
    with many nodes on leaf boundaries and in the boundary leaves (clipped
    neighbor ids), and "gap", two clusters with empty leaves between them
    and 40 targets piled into one leaf (more than one item there);
    "pile", the same with 150 (items of 64, 64 and 32 + a remainder)."""
    rng = np.random.default_rng(seed)
    if kind == "boundary":
        o = rng.uniform(-2, 2, (120, 3))
        d = rng.normal(size=(120, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        src = (o[:, None] + np.linspace(0, 1, 24)[None, :, None]
               * d[:, None]).reshape(-1, 3)
        src[::5, 0] = 0.0
        trg = src
    else:
        src = np.concatenate([rng.uniform(-3, -2, (1500, 3)),
                              rng.uniform(2, 3, (1500, 3))])
        pile = 40 if kind == "gap" else 150
        trg = np.concatenate([src, np.full((pile, 3), 2.9)
                              + 1e-4 * rng.standard_normal((pile, 3))])
    return src, trg


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["boundary", "gap", "pile"])
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_tree_kernel_matches_plain_twin(cuda, family, prec, kind):
    """Kernels G / H against their plain twin on the card, on the same
    lists (`ops.treecode.tree_operands` at depth 3): 1e-5 of the largest
    velocity in f32, 1e-12 in f64; one launch counted; two launches give
    the same bits; every target written."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import treecode as ttc

    src, trg = _tree_cloud(kind)
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-4)
    assert plan.depth == 3
    cols = 3 if family == "stokeslet" else 9
    dt = torch.float32 if prec == "f32" else torch.float64
    pay = np.random.default_rng(1).standard_normal((len(src), cols))
    ops = ttc.tree_operands(plan, ev.make_pair(plan, cuda).anchors,
                            *(torch.as_tensor(a, dtype=dt, device=cuda)
                              for a in (src, pay, trg)))
    t_s, sa, pa, items, segs, _, counts = ops
    assert int(counts.max()) <= plan.max_occ
    if kind != "boundary":
        assert int((counts == 0).sum()) > 0
        assert int(items[:, 1].min()) < ck.TREE_ITEM_TARGETS
    if kind == "pile":
        assert int(items[:, 1].max()) == ck.TREE_ITEM_TARGETS
    assert set(ck.tree_item_lanes(items[:, 1]).tolist()) >= (
        {4, 8, 16, 32} if kind == "pile" else {4})
    kern = getattr(ck, f"tree_{family}_{prec}")
    n0 = kern.launches
    got = kern(t_s, sa, pa, items, segs, 0.9)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert torch.equal(kern(t_s, sa, pa, items, segs, 0.9), got)
    ref = getattr(ck, f"tree_{family}_f64_plain")(
        t_s.double(), sa.double(), pa.double(), items, segs, 0.9)
    assert _rel_err(got, ref) < (1e-5 if prec == "f32" else 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_tree_sum_card_matches_cpu(cuda, family):
    """`stokeslet_tree` / `stresslet_tree` in f64 on the card (kernel G /
    H) and on the CPU (the plain twin) agree to 1e-12."""
    from skellysim_tpu_torch.ops import treecode as ttc

    src, trg = _tree_cloud("boundary", seed=3)
    plan = ttc.plan_tree(src, tol=1e-4)
    assert plan.depth >= 2
    rng = np.random.default_rng(2)
    pay = (rng.standard_normal((len(src), 3)) if family == "stokeslet"
           else rng.standard_normal((len(src), 3, 3)))
    fn = getattr(ttc, f"{family}_tree")
    out = {dev: fn(plan, *(torch.as_tensor(a, device=dev)
                           for a in (src, trg, pay)), 1.1).cpu()
           for dev in (cuda, "cpu")}
    assert _rel_err(out[cuda], out["cpu"]) < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_tree_redesign_matches_first_design(cuda, family, prec):
    """Kernels G / H against their first design (`tree_*_v1`, over its own
    items of 32 on the same segments) on the same inputs: within summation
    order, 2e-6 of the largest velocity in f32 and 1e-13 in f64; both
    against the f64 twin at the twin test's gates; the yardstick counts its
    own launches."""
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import treecode as ttc

    src, trg = _tree_cloud("pile", seed=4)
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-4)
    cols = 3 if family == "stokeslet" else 9
    dt = torch.float32 if prec == "f32" else torch.float64
    pay = np.random.default_rng(7).standard_normal((len(src), cols))
    args = [torch.as_tensor(a, dtype=dt, device=cuda)
            for a in (src, pay, trg)]
    anchors = ev.make_pair(plan, cuda).anchors
    new = ttc.tree_operands(plan, anchors, *args)
    old = ttc.tree_operands(plan, anchors, *args, v1=True)
    assert torch.equal(new[4], old[4])
    kern = getattr(ck, f"tree_{family}_{prec}")
    v1 = getattr(ck, f"tree_{family}_{prec}_v1")
    n0 = v1.launches
    got = kern(*new[:5], 1.3)
    ref_v1 = v1(*old[:5], 1.3)
    torch.cuda.synchronize()
    assert v1.launches == n0 + 1
    assert _rel_err(got, ref_v1.double()) < (2e-6 if prec == "f32"
                                             else 1e-13)
    twin = getattr(ck, f"tree_{family}_f64_plain")(
        *(a.double() for a in new[:3]), new[3], new[4], 1.3)
    for u in (got, ref_v1):
        assert _rel_err(u, twin) < (1e-5 if prec == "f32" else 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_tree_sum_after_its_geometry_makes_no_host_sync(cuda, family):
    """A `PairEvaluator`'s second tree sum over the same positions (the
    geometry kept from the first) runs under
    `torch.cuda.set_sync_debug_mode("error")`, and gives the first's bits
    on the same payload."""
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import treecode as ttc

    src, trg = _tree_cloud("gap", seed=5)
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-4)
    pair = ev.make_pair(plan, cuda)
    P, T = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
            for a in (src, trg))
    rng = np.random.default_rng(8)
    shape = (len(src), 3) if family == "stokeslet" else (len(src), 3, 3)
    q = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)

    def run():
        if family == "stokeslet":
            return pair.stokeslet(P, T, q, 0, 1.0)
        return pair.stresslet(P, T, q, 1.0)

    first = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, first)


@pytest.mark.gpu
def test_profiled_step_attributes_hand_written_kernels(cuda, tmp_path):
    """One small "mixed" step of the coupled scene under `System.run(
    profile_dir=)` on the card: Kineto's dump holds kernel events of A-D
    whose correlation ids lead to their host launches (``cuda_runtime`` or
    ``cuda_driver``), and `load_device_trace` files them under named
    phases of the Krylov solve and the prep; at least 90% of the device
    time is attributed."""
    from skellysim_tpu_torch.obs import profile as prof
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    p = Params(dt_initial=0.02, t_final=0.02, gmres_tol=1e-12,
               solver_precision="mixed", kernel_impl="pallas",
               refine_pair_impl="pallas_df")
    shell, shape, bodies, fibers = make_coupled_scene(
        shell_n=120, body_n=80, n_bound=4, n_free=2, device="cuda",
        precond_dtype=torch.float32)
    system = System(p, shell_shape=shape, device="cuda")
    state = system.make_state(fibers=fibers, shell=shell, bodies=bodies)
    system.run(state, max_steps=1)     # the libraries load outside
    system.run(state, max_steps=1, profile_dir=str(tmp_path))
    (path,) = prof.find_profile_files(str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    launches = {e["args"]["correlation"]: e["cat"] for e in events
                if e.get("cat") in prof.LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})}
    ours = [e for e in events if e.get("cat") == "kernel"
            and ("stokeslet_chunk_kernel" in e["name"]
                 or "stresslet_chunk_kernel" in e["name"])]
    assert {"float", "double"} <= {
        t for e in ours for t in ("float", "double")
        if f"<{t}," in e["name"]}, [e["name"] for e in ours][:4]
    assert all(e["args"]["correlation"] in launches for e in ours)
    trace = prof.load_device_trace(str(tmp_path))
    phases = {}
    for e in trace.events:
        if "_chunk_kernel" in e["name"]:
            phases.setdefault(e["phase"], 0)
            phases[e["phase"]] += 1
    assert None not in phases, phases
    assert any(k.startswith("gmres/") for k in phases), phases
    assert "prep" in phases, phases
    assert trace.attributed_frac >= 0.9, prof.render_table(trace)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["exact", "pallas_df", "df", "mxu"])
def test_counted_pair_sums_on_the_card(cuda, impl):
    """Under `obs.cost.CostCounter` a direct sum on the card counts what
    it counts on the CPU (22 / 40 flops a pair, the operands' bytes, no
    aten op of the tile or its staging) and gives the uncounted bits; A-D
    still launch where ``impl`` routes to them."""
    from skellysim_tpu_torch.obs import cost
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.ops import kernels

    counts = {}
    for dev in ("cpu", "cuda"):
        src, trg, f = (t.to(torch.float32)
                       for t in _cloud(3000, 2000, torch.float64, dev))
        S = f[:, :, None] * f[:, None, :]
        for family, pay in (("stokeslet", f), ("stresslet", S)):
            fn = getattr(kernels, f"{family}_direct")
            ref = fn(src, trg, pay, 1.0, impl=impl)
            before = sum(w.launches for w in ck.KERNEL_WRAPPERS)
            with cost.CostCounter() as c:
                got = fn(src, trg, pay, 1.0, impl=impl)
            assert torch.equal(got, ref)
            counts[dev, family] = (c.pairs, c.flops, c.bytes_accessed, c.ops)
            launched = sum(w.launches for w in ck.KERNEL_WRAPPERS) - before
            assert launched == (dev == "cuda" and impl in ("exact",
                                                           "pallas_df"))
    for family in ("stokeslet", "stresslet"):
        assert counts["cuda", family] == counts["cpu", family]
        assert counts["cpu", family][1] == cost.PAIR_FLOPS[family] * 6e6
        assert counts["cpu", family][3] == 0


@pytest.mark.gpu
def test_cost_check_on_the_card(cuda):
    """`obs cost --check` on the card against the checked-in CPU
    baselines: no finding, every program's pair-seam totals and flops the
    CPU's, its bytes within 1% (a copy between devices counts 0)."""
    from skellysim_tpu_torch.audit.programs import all_programs
    from skellysim_tpu_torch.config import toml_io
    from skellysim_tpu_torch.obs import cost

    rows, findings = cost.audit_costs(all_programs(), device="cuda")
    assert findings == [], [f.render() for f in findings]
    for row in rows:
        base = toml_io.load(cost.baseline_path(row["name"]))
        assert {k: row[k] for k in cost.PAIR_KEYS} == base["pair_seam"], \
            row["name"]
        for key, rel in (("flops", 1e-9), ("bytes_accessed", 1e-2)):
            assert abs(row[key] - base["cost"][key]) \
                <= rel * base["cost"][key], (row["name"], key)
        assert row["device_max_allocated"] > 0


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
    jax (or jaxlib) and none of the JAX package `skellysim_tpu`; the
    ParaView scripts under `paraview_utils/` import neither package (and
    nothing relative)."""
    files = sorted((REPO / "skellysim_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    names = {os.path.relpath(f, REPO) for f in files}
    for mod in ("mesh", "compat", "ring", "spmd", "multihost"):
        assert f"skellysim_tpu_torch/parallel/{mod}.py" in names
    for mod in ("obs/flight", "serve/protocol", "postprocess/streamline",
                "listener", "io/listener_client", "obs/tracer", "obs/hist",
                "obs/summarize", "serve/__init__", "serve/__main__",
                "serve/cli", "serve/client", "serve/journal",
                "serve/metrics", "serve/server", "serve/tenants",
                "guard/chaos", "guard/smoke", "obs/profile", "obs/timeline",
                "obs/cli", "obs/__main__", "audit/__init__", "audit/engine",
                "audit/registry", "audit/fixtures", "audit/programs",
                "obs/cost", "obs/roofline", "audit/observe",
                "audit/checks", "audit/maskflow", "audit/repflow",
                "audit/dmaflow", "audit/kernels", "audit/cli",
                "audit/__main__", "io/eigen", "io/trajectory",
                "native/__init__", "native/build", "config/param_tools",
                "config/schema", "ops/kernels", "fibers/container",
                "bodies/deformable", "fibers/chebyshev",
                "fibers/chebyshev_fiber"):
        assert f"skellysim_tpu_torch/{mod}.py" in names
    # the ParaView scripts run outside either package: vtk, never a package
    scripts = ("__init__", "trajectory_utility", "fiber_reader",
               "fiber_reader_request", "body_reader", "field_reader",
               "field_reader_request")
    for mod in scripts:
        assert f"skellysim_tpu_torch/paraview_utils/{mod}.py" in names
    bad = []
    for f in files:
        script = os.path.relpath(f, REPO).startswith(
            "skellysim_tpu_torch/paraview_utils/")
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "skellysim_tpu") or (
                    script and top == "skellysim_tpu_torch"):
                bad.append(f"{os.path.relpath(f, REPO)}: {mod}")
        if script:
            assert not any(isinstance(n, ast.ImportFrom) and n.level
                           for n in ast.walk(ast.parse(f.read_text()))), f
    assert not bad, bad


# ------------------------------------------------------------- the auditor

@pytest.mark.gpu
def test_audit_host_syncs_match_the_sync_debug_mode(cuda):
    """The auditor's observer (`audit.observe`) counts every host sync of a
    registered program's run that `torch.cuda.set_sync_debug_mode("warn")`
    warns about, program by program, on the card."""
    import warnings

    from skellysim_tpu_torch.audit import maskflow
    from skellysim_tpu_torch.audit.engine import ProgramRun, load_contract
    from skellysim_tpu_torch.audit.programs import all_programs

    def debug_syncs(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in seen)

    debug_syncs(lambda: None)
    for prog in all_programs():
        contract, _ = load_contract(prog.name)
        run = ProgramRun(prog, cuda, contract)
        built = prog.build(cuda)
        args = maskflow.with_dead_slots(built.args, run.axes)
        torch.cuda.synchronize()
        assert debug_syncs(lambda: built.fn(*args, **built.kwargs)) \
            == run.observation.syncs, prog.name


@pytest.mark.gpu
def test_audit_dma_runs_on_a_to_h(cuda):
    """The dma check on every registered kernel family (A-H): the
    resources within the pins and the card's limits, 20 repeats with the
    same bits and the plain version's result; the CLI clean on the
    card."""
    from skellysim_tpu_torch.audit import dmaflow
    from skellysim_tpu_torch.audit.cli import main as audit_main
    from skellysim_tpu_torch.audit.engine import run_kernel_audit
    from skellysim_tpu_torch.audit.kernels import all_kernels

    letters = set()
    for kern in all_kernels():
        rep = dmaflow.analyze(kern.build(cuda))
        assert rep.findings == [], kern.name
        assert run_kernel_audit(kern, checks=["dma"], device=cuda) == []
        letters |= {c.label.split()[0] for c in kern.build(cuda).cases}
    assert letters == set("ABCDEFGH")
    assert audit_main(["--check", "dma"]) == 0
