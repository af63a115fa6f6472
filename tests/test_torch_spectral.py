"""The port's periodic spectral Ewald evaluator
(`skellysim_tpu_torch.ops.spectral`) against the JAX package.

* `plan_spectral` gives the JAX package's plan field for field, triply
  periodic (3 lengths) and doubly periodic (a slab, 2 lengths), with and
  without fill capacity, and snaps its grid onto the same rungs (the
  built-in ladder and a custom one);
* on the same plan, in f64, the Stokeslet and stresslet sums in both
  modes agree with the JAX package's to 1e-12 relative;
* the config schema's periodic pairing checks report the same problems
  as the JAX schema's, and `System` refuses the same pairings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skellysim_tpu.config import schema as jschema
from skellysim_tpu.ops import spectral as jsp
from skellysim_tpu_torch.config import schema as tschema
from skellysim_tpu_torch.ops import evaluator as tev
from skellysim_tpu_torch.ops import spectral as tsp
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.system import System

TP_BOX = (4.0, 4.0, 4.0)
DP_BOX = (4.0, 3.0)


def _cloud(box, n=300, seed=5):
    """Points inside the box (a slab's free axis spans 1.5), forces and
    stresslet densities."""
    rng = np.random.default_rng(seed)
    ext = np.array(box if len(box) == 3 else box + (1.5,))
    return (rng.uniform(0, 1, (n, 3)) * ext, rng.standard_normal((n, 3)),
            rng.standard_normal((n, 3, 3)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _plans(pts, box, **kw):
    jp = jsp.plan_spectral(pts, box, 1.0, **kw)
    tp = tsp.plan_spectral(pts, box, 1.0, **kw)
    assert tp.__dict__ == jp.__dict__
    return jp, tp


@pytest.mark.parametrize("box,kw", [
    (TP_BOX, dict(tol=1e-6)), (DP_BOX, dict(tol=1e-6)),
    (TP_BOX, dict(tol=1e-4, n_fill=90)), (DP_BOX, dict(tol=1e-5, n_fill=40)),
])
def test_plan_equals_jax(box, kw):
    pts = _cloud(box)[0]
    jp, tp = _plans(pts, box, **kw)
    assert tp.mode == ("tp" if len(box) == 3 else "dp")
    pair = tev.make_pair(tp, "cpu")
    assert pair.evaluator == "spectral"
    np.testing.assert_array_equal(pair.anchors.numpy(),
                                  np.asarray(jsp.plan_anchors(jp)))
    if kw.get("n_fill"):
        tf = pair.fill_positions(kw["n_fill"], torch.float64)
        jf = jsp.fill_positions(jp, jsp.plan_anchors(jp)[1], kw["n_fill"],
                                jnp.float64)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize("box", [TP_BOX, DP_BOX])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_sums_match_jax(box, family):
    pts, f, S = _cloud(box, seed=11)
    jp, tp = _plans(pts, box, tol=1e-6)
    # unwrapped positions: both wrap them against the cell anchor
    src = pts + np.array([4.0, -4.0, 0.0])
    if family == "stokeslet":
        uj = jsp.stokeslet_spectral(jp, jnp.asarray(src), jnp.asarray(pts),
                                    jnp.asarray(f), n_self=len(pts))
        ut = tsp.stokeslet_spectral(tp, torch.tensor(src), torch.tensor(pts),
                                    torch.tensor(f), n_self=len(pts))
    else:
        uj = jsp.stresslet_spectral(jp, jnp.asarray(src), jnp.asarray(pts),
                                    jnp.asarray(S))
        ut = tsp.stresslet_spectral(tp, torch.tensor(src), torch.tensor(pts),
                                    torch.tensor(S))
    assert _rel(ut.numpy(), np.asarray(uj)) <= 1e-12


@pytest.mark.parametrize("ladder", [(), (20, 40, 80, 160)])
def test_grid_ladder_rungs(ladder):
    pts = _cloud(TP_BOX)[0]
    _, tp = _plans(pts, TP_BOX, tol=1e-6, grid_ladder=ladder)
    assert all(m in (ladder or tsp.GRID_RUNGS) for m in tp.M3)
    assert tsp._grid_rung(17, (16, 24, 32)) == 24
    assert tsp._grid_rung(99, (16, 24, 32)) == 32


_PAIRINGS = [
    dict(pair_evaluator="spectral", periodic_box=[4.0, 4.0, 4.0]),
    dict(pair_evaluator="spectral", periodic_box=[4.0, 4.0]),
    dict(pair_evaluator="PVFMM", periodic_box=[4.0, 4.0, 4.0]),
    dict(pair_evaluator="spectral"),
    dict(pair_evaluator="FMM", periodic_box=[4.0, 4.0, 4.0]),
    dict(pair_evaluator="direct", periodic_box=[4.0, 4.0, 4.0]),
    dict(pair_evaluator="spectral", periodic_box=[4.0]),
    dict(pair_evaluator="spectral", periodic_box=[4.0, -1.0, 4.0]),
]


@pytest.mark.parametrize("params", _PAIRINGS)
def test_schema_periodic_pairing_matches_jax(params):
    def periodic(mod):
        cfg = mod.Config(params=mod.Params(**params))
        return [p for p in cfg.validate() if "periodic" in p]

    assert periodic(tschema) == periodic(jschema)


def test_system_refuses_unpaired_boxes():
    with pytest.raises(ValueError, match="periodic_box"):
        System(Params(pair_evaluator="spectral"), device="cpu")
    with pytest.raises(ValueError, match="periodic_box"):
        System(Params(pair_evaluator="direct", periodic_box=(4.0,) * 3),
               device="cpu")
    System(Params(pair_evaluator="spectral", periodic_box=(4.0, 4.0)),
           device="cpu")
