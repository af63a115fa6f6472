"""The port's remaining kernel-module and container names against the JAX
package's, in float64 on inputs made from a numpy seed:

* `ops.kernels.stresslet_times_normal` (the unblocked [n, 3, n, 3]
  operator) and `oseen_block` within 1e-12 of the JAX functions, relative
  to each result's largest entry; `stresslet_times_normal` reshaped equals
  the port's `stresslet_times_normal_blocked` bit for bit at its default
  row block (and to 1e-15 at a block of 7 rows, einsum's order);
* `fibers.container.flow` (one bucket through `flow_multi`'s seam) within
  1e-12 of the JAX `flow` on 4 fibers x 16 nodes, with and without the
  self-interaction subtracted, and equal to `flow_multi` of the same
  bucket bit for bit;
* `fibers.container.sort_fibers_morton`: the JAX permutation exactly, with
  every per-fiber leaf carried along (a node-padded group and a float32
  group too);
* `audit.kernels.get_kernel`, the JAX package's registry lookup.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.ops import kernels as jk
from skellysim_tpu_torch.convert import group_from_numpy
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.ops import kernels as tk

ETA, DT = 1.3, 0.013


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * scale)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, 3))
    nrm = rng.standard_normal((n, 3))
    return r, nrm / np.linalg.norm(nrm, axis=1, keepdims=True), rng


@pytest.mark.parametrize("coincident", [False, True])
def test_stresslet_times_normal_matches_jax_and_the_blocked_form(coincident):
    r, nrm, _ = _cloud(40, 1)
    if coincident:
        # two distinct nodes at one point: the regularized value, kept
        r[7] = r[3]
    ref = jk.stresslet_times_normal(jnp.asarray(r), jnp.asarray(nrm), ETA)
    got = tk.stresslet_times_normal(torch.as_tensor(r), torch.as_tensor(nrm),
                                    ETA)
    assert got.shape == (40, 3, 40, 3)
    _close(got, ref)
    # the default row block holds all 40 rows: the same arithmetic, the
    # same bits; a smaller block changes einsum's reduction order by 1 ulp
    blocked = tk.stresslet_times_normal_blocked(
        torch.as_tensor(r), torch.as_tensor(nrm), ETA)
    assert torch.equal(got.reshape(120, 120), blocked)
    blocked = tk.stresslet_times_normal_blocked(
        torch.as_tensor(r), torch.as_tensor(nrm), ETA, block_size=7)
    _close(got.reshape(120, 120), blocked.numpy(), tol=1e-15)


@pytest.mark.parametrize("reg,eps", [(5e-3, 1e-5), (0.1, 0.3)])
def test_oseen_block_matches_jax(reg, eps):
    trg, _, rng = _cloud(30, 2)
    src = np.concatenate([rng.standard_normal((20, 3)), trg[:5]])
    dens = rng.standard_normal((25, 3))
    ref = jk.oseen_block(jnp.asarray(trg), jnp.asarray(src),
                         jnp.asarray(dens), ETA, reg, eps)
    got = tk.oseen_block(torch.as_tensor(trg), torch.as_tensor(src),
                         torch.as_tensor(dens), ETA, reg, eps)
    _close(got, ref)
    np.testing.assert_array_equal(
        tk.oseen_contract(torch.as_tensor(src), torch.as_tensor(trg),
                          torch.as_tensor(dens), ETA, reg, eps).numpy(),
        got.numpy())


def _jax_group(nf, n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    x = np.stack([np.stack([t, 0.1 * np.sin(2 * t + i), 0.05 * t**2], 1)
                  + rng.uniform(-3, 3, 3) for i in range(nf)])
    g = jfc.make_group(x, lengths=1.0, bending_rigidity=0.05, radius=0.0125,
                       minus_clamped=rng.random(nf) > 0.5,
                       binding_body=rng.integers(-1, 3, nf),
                       binding_site=rng.integers(0, 9, nf))
    return g, rng


def _port(g):
    return group_from_numpy({k: (None if v is None else np.asarray(v))
                             for k, v in g._asdict().items()}, device="cpu")


@pytest.mark.parametrize("subtract_self", [True, False])
def test_flow_matches_jax_on_one_bucket(subtract_self):
    g, rng = _jax_group(4, 16, seed=3)
    g = g._replace(active=jnp.asarray([True, True, False, True]))
    tg = _port(g)
    forces = rng.standard_normal((4, 16, 3))
    r_trg = np.concatenate([np.asarray(g.x).reshape(-1, 3),
                            rng.standard_normal((10, 3))])
    jc, tc = jfc.update_cache(g, DT, ETA), tfc.update_cache(tg, DT, ETA)
    ref = jfc.flow(g, jc, jnp.asarray(r_trg), jnp.asarray(forces), ETA,
                   subtract_self=subtract_self)
    got = tfc.flow(tg, tc, torch.as_tensor(r_trg), torch.as_tensor(forces),
                   ETA, subtract_self=subtract_self)
    _close(got, ref)
    multi = tfc.flow_multi((tg,), (tc,), torch.as_tensor(r_trg),
                           (torch.as_tensor(forces),), ETA,
                           subtract_self=subtract_self)
    assert torch.equal(got, multi)


@pytest.mark.parametrize("variant", ["plain", "node_padded", "float32"])
def test_sort_fibers_morton_matches_jax(variant):
    rng = np.random.default_rng(5)
    nf, n = 64, 16
    x = (rng.uniform(-4, 4, (nf, 1, 3))
         + np.cumsum(0.05 * rng.standard_normal((nf, n, 3)), axis=1))
    g = jfc.make_group(x, lengths=rng.uniform(0.5, 1.5, nf),
                       bending_rigidity=0.05, radius=0.0125,
                       minus_clamped=rng.random(nf) > 0.5,
                       binding_body=rng.integers(-1, 3, nf))
    g = g._replace(tension=jnp.asarray(rng.standard_normal((nf, n))),
                   active=jnp.asarray(rng.random(nf) > 0.2))
    tg = _port(g)
    if variant == "node_padded":
        g, tg = jfc.grow_node_capacity(g, 24), tfc.grow_node_capacity(tg, 24)
    if variant == "float32":
        g = g._replace(x=g.x.astype(jnp.float32))
        tg = tg._replace(x=tg.x.float())
    ref, got = jfc.sort_fibers_morton(g), tfc.sort_fibers_morton(tg)
    order = got.config_rank.numpy()
    np.testing.assert_array_equal(order, np.asarray(ref.config_rank))
    assert sorted(order.tolist()) == list(range(nf))
    assert order.tolist() != list(range(nf))
    for name, leaf in ref._asdict().items():
        if name == "rt_mats" or leaf is None:
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(leaf), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(tg, name).numpy()[order],
                                      err_msg=name)
    assert (got.rt_mats is None) == (variant != "node_padded")


def test_get_kernel_looks_up_the_registry():
    """`audit.kernels.get_kernel`, the JAX package's lookup: every
    registered family by name, and a KeyError naming them otherwise."""
    from skellysim_tpu_torch.audit.kernels import all_kernels, get_kernel

    names = [k.name for k in all_kernels()]
    assert len(names) == 6
    assert [get_kernel(n).name for n in names] == names
    with pytest.raises(KeyError, match="registered: " + ", ".join(names)):
        get_kernel("no_such_kernel")
