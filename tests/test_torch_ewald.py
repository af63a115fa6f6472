"""The port's free-space Ewald evaluator (`skellysim_tpu_torch.ops.ewald`)
and the pair-evaluator seam (`ops.evaluator`) against the JAX package.

* `plan_ewald` gives the JAX package's plan field for field (a random
  cloud, a fiber-line cloud in blocks mode, a cloud with fill capacity),
  and `fill_positions` the same points;
* on the same plan, in f64, the Stokeslet sum (self targets, disjoint
  targets, the mixed [sources | others] layout) and the stresslet sum
  agree with the JAX package's to 1e-12 relative;
* in blocks mode, with K covering every block, the same to 1e-12, and to
  10 x tol against the port's plain dense sum;
* f32 operands stay within 3e-3 of the dense f64 sum at tol 1e-4 (the JAX
  test's gate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skellysim_tpu.ops import ewald as jew
from skellysim_tpu_torch.ops import evaluator as tev
from skellysim_tpu_torch.ops import ewald as tew
from skellysim_tpu_torch.ops import kernels as tk


def _cloud(n, seed, box=3.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-box, box, (n, 3)), rng.standard_normal((n, 3))


def _fiber_cloud(nf=8, nn=64, spread=0.3, seed=43):
    """Line-clustered nodes (fibers of length 1 bunched together): the
    blocks near-field mode's cloud, with every block within reach."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (nf, 3))
    dirs = rng.normal(size=(nf, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.linspace(0, 1, nn)
    pts = (origins[:, None, :] + t[None, :, None] * dirs[:, None, :]
           ).reshape(-1, 3)
    return pts, rng.standard_normal(pts.shape)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _plans(pts, **kw):
    jp = jew.plan_ewald(pts, **kw)
    tp = tew.plan_ewald(pts, **kw)
    assert tp.__dict__ == jp.__dict__
    return jp, tp


@pytest.mark.parametrize("cloud,kw", [
    ("random", dict(eta=1.3, tol=1e-6)),
    ("fibers", dict(eta=1.0, tol=1e-5)),
    ("random", dict(eta=0.7, tol=1e-4, n_fill=150)),
])
def test_plan_equals_jax(cloud, kw):
    pts = _cloud(400, 3)[0] if cloud == "random" else _fiber_cloud()[0]
    jp, tp = _plans(pts, **kw)
    if cloud == "fibers":
        assert tp.near_mode == "blocks" and tp.K == 4
    if kw.get("n_fill"):
        assert tp.near_mode == "cells"
    assert tp.__dict__ == jp.__dict__
    np.testing.assert_array_equal(tev.make_pair(tp, "cpu").anchors.numpy(),
                                  np.asarray(jew.plan_anchors(jp)))


def test_fill_positions_equal_jax():
    pts = _cloud(300, 5)[0]
    jp, tp = _plans(pts, eta=1.0, tol=1e-6, n_fill=77)
    tf = tev.make_pair(tp, "cpu").fill_positions(77, torch.float64)
    jf = jew.fill_positions(jp, jew.plan_anchors(jp)[1], 77, jnp.float64)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(tf.numpy(), jew._fill_positions_np(
        (tp.cell_lo, tp.cells3, tp.cell_size), 77), rtol=0, atol=1e-14)


@pytest.mark.parametrize("targets", ["self", "disjoint", "mixed"])
def test_stokeslet_matches_jax(targets):
    src, f = _cloud(300, 7)
    extra = np.random.default_rng(8).uniform(-3, 3, (77, 3))
    trg = {"self": src, "disjoint": extra,
           "mixed": np.vstack([src, extra])}[targets]
    n_self = 0 if targets == "disjoint" else len(src)
    jp, tp = _plans(np.vstack([src, extra]), eta=1.1, tol=1e-6)
    uj = np.asarray(jew.stokeslet_ewald(jp, jnp.asarray(src),
                                        jnp.asarray(trg), jnp.asarray(f),
                                        n_self=n_self))
    ut = tew.stokeslet_ewald(tp, torch.tensor(src), torch.tensor(trg),
                             torch.tensor(f), n_self=n_self).numpy()
    assert _rel(ut, uj) <= 1e-12
    dense = tk.stokeslet_direct(torch.tensor(src), torch.tensor(trg),
                                torch.tensor(f), 1.1).numpy()
    assert _rel(ut, dense) < 1e-5


@pytest.mark.parametrize("targets", ["self", "disjoint"])
def test_stresslet_matches_jax(targets):
    rng = np.random.default_rng(57)
    src = rng.uniform(-3, 3, (300, 3))
    S = rng.standard_normal((300, 3, 3))
    trg = src if targets == "self" else rng.uniform(-3, 3, (77, 3))
    jp, tp = _plans(np.vstack([src, trg]), eta=1.3, tol=1e-6)
    uj = np.asarray(jew.stresslet_ewald(jp, jnp.asarray(src),
                                        jnp.asarray(trg), jnp.asarray(S)))
    ut = tew.stresslet_ewald(tp, torch.tensor(src), torch.tensor(trg),
                             torch.tensor(S)).numpy()
    assert _rel(ut, uj) <= 1e-12
    dense = tk.stresslet_direct(torch.tensor(src), torch.tensor(trg),
                                torch.tensor(S), 1.3).numpy()
    assert _rel(ut, dense) < 1e-4


def test_blocks_mode_matches_jax_and_dense():
    """K covers every source block, so `torch.topk` and `lax.top_k` keep
    the same blocks whatever their tie order."""
    pts, f = _fiber_cloud()
    tol = 1e-5
    jp, tp = _plans(pts, eta=1.0, tol=tol)
    assert tp.near_mode == "blocks" and tp.K == len(pts) // tp.block
    n = len(pts)
    uj = np.asarray(jew.stokeslet_ewald(jp, jnp.asarray(pts),
                                        jnp.asarray(pts), jnp.asarray(f),
                                        n_self=n))
    P, F = torch.tensor(pts), torch.tensor(f)
    ut = tew.stokeslet_ewald(tp, P, P, F, n_self=n).numpy()
    assert _rel(ut, uj) <= 1e-12
    dense = tk.stokeslet_direct(P, P, F, 1.0).numpy()
    assert _rel(ut, dense) <= 10 * tol


def test_f32_operands_against_dense():
    pts, f = _cloud(400, 13)
    plan = tew.plan_ewald(pts, eta=1.0, tol=1e-4)
    P32 = torch.tensor(pts, dtype=torch.float32)
    u = tew.stokeslet_ewald(plan, P32, P32,
                            torch.tensor(f, dtype=torch.float32))
    assert u.dtype == torch.float32
    dense = tk.stokeslet_direct(torch.tensor(pts), torch.tensor(pts),
                                torch.tensor(f), 1.0).numpy()
    assert _rel(u.double().numpy(), dense) < 3e-3


def test_pair_evaluator_seam():
    """`make_pair` keeps the plan and puts its anchors on the device; its
    sums are the module's at another viscosity; a plan type the port does
    not know raises TypeError."""
    pts, f = _cloud(200, 31)
    plan = tew.plan_ewald(pts, eta=1.0, tol=1e-5)
    pair = tev.make_pair(plan, "cpu")
    assert pair.plan is plan and pair.evaluator == "ewald"
    np.testing.assert_array_equal(pair.anchors.numpy(),
                                  np.array([plan.box_lo, plan.cell_lo]))
    P, F = torch.tensor(pts), torch.tensor(f)
    np.testing.assert_allclose(
        pair.stokeslet(P, P, F, len(pts), 2.0).numpy(),
        tew.stokeslet_ewald(plan, P, P, F).numpy() / 2.0, rtol=1e-15,
        atol=0)
    with pytest.raises(TypeError):
        tev.make_pair(object(), "cpu")
    assert tev.EVALUATOR_ALIASES["fmm"] == "ewald"
    assert tev.EVALUATOR_ALIASES["pvfmm"] == "spectral"


def test_split_closed_forms_match_jax():
    """G_near + G_far is the exact Stokeslet pointwise (machine epsilon),
    and the closed forms `g_far_pair` and `bhat_far_trunc` are the JAX
    package's."""
    rng = np.random.default_rng(0)
    eta, xi = 1.3, 1.7
    d = rng.uniform(-3, 3, (200, 3))
    G_far = tew.g_far_pair(torch.tensor(d), xi, eta).numpy()
    np.testing.assert_allclose(
        G_far, np.asarray(jew.g_far_pair(jnp.asarray(d), xi, eta)),
        rtol=0, atol=1e-15)
    G_near = np.stack([tew.stokeslet_near_block(
        torch.tensor(d), torch.zeros((1, 3), dtype=torch.float64),
        torch.eye(3, dtype=torch.float64)[k:k + 1], xi).numpy()
        for k in range(3)], axis=-1) / (8 * np.pi * eta)
    r = np.linalg.norm(d, axis=1)
    rhat = d / r[:, None]
    G = (np.eye(3)[None] / r[:, None, None]
         + rhat[:, :, None] * rhat[:, None, :] / r[:, None, None]) \
        / (8 * np.pi * eta)
    assert np.abs(G_near + G_far - G).max() < 1e-15
    k = np.linspace(0.0, 20.0, 301)
    np.testing.assert_allclose(
        tew.bhat_far_trunc(torch.tensor(k), xi, 4.0).numpy(),
        np.asarray(jew.bhat_far_trunc(jnp.asarray(k), xi, 4.0)),
        rtol=1e-12, atol=1e-300)
