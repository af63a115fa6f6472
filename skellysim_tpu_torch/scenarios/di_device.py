"""Dynamic instability on the device: nucleation and catastrophe as mask
flips over a fixed-capacity fiber batch.

Counterpart of `skellysim_tpu.scenarios.di_device`, whose docstring gives
the design. The host update (`system.dynamic_instability`) re-buckets
fibers in numpy; this one keeps the member's capacity and flips masks with
`torch.where` selects on the state's device, so every lane of an ensemble
round keeps its shapes:

* catastrophe: one uniform draw a capacity slot against P(die) = 1 -
  exp(-dt f_cat) (`system.di_rates`, ``xp=torch``, float64); a dying fiber
  turns inactive and frees its site;
* growth: survivors grow by dt v_growth;
* nucleation: Poisson(dt rate n_inactive) capped by the free sites; the
  free sites ranked by a uniform priority draw fill the inactive slots in
  order, each fiber radial out of its body at ``min_length``.

The draws are the JAX package's bit for bit: each member carries its
`SimRNG.member(i)` ``distributed`` stream as data, (seed, stream id,
counter), and a round folds counter + 0 / 1 / 2 into the stream's key as
`utils.rng.Stream` does (`sample_draws`, numpy threefry on the host). The
Poisson mean needs the member's live count, so a round reads two small
counts back from the device a member (the round trip the ensemble's
``di_s`` reports); everything else stays on the device.

When a nucleation burst wants more slots than the batch holds, the update
aborts for that member (state untouched, counter not advanced) and
``DIInfo.needs_growth`` tells the scheduler to reseat it on the next
capacity rung (`scenarios.sweep`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bodies import bodies as bd
from ..fibers import container as fc, fd_fiber
from ..obs.profile import phase
from ..system import di_rates
from ..utils import rng as rng_mod

#: keys a round consumes (u_cat / poisson / u_site): the runner advances
#: the member's stream counter by this after every round the member drew
DRAWS_PER_STEP = 3


class DIDraws(NamedTuple):
    """One round's stochastic inputs (the injection seam of the tests):
    ``u_cat`` [capacity] uniforms in [0, 1) (0 never dies), ``n_raw`` the
    un-capped Poisson count, ``u_site`` [n_sites] site priorities (the
    lowest free ones nucleate, in ascending order). numpy on the host."""

    u_cat: np.ndarray
    n_raw: int
    u_site: np.ndarray


class DIInfo(NamedTuple):
    """One member's outcome of a device DI update (host ints)."""

    nucleations: int       # slots filled (0 on abort)
    catastrophes: int      # fibers deactivated (0 on abort)
    active_fibers: int     # live count after the update
    #: the burst outgrew the capacity bucket: the update was aborted
    needs_growth: bool


class SiteTable(NamedTuple):
    """Flat lab-frame nucleation-site table over every body bucket, in the
    host path's order (body-major, site-minor)."""

    sites: torch.Tensor   # [S, 3] lab-frame positions
    coms: torch.Tensor    # [S, 3] owning body centres
    gids: torch.Tensor    # [S] int32 global body ids (config_rank)
    sids: torch.Tensor    # [S] int32 per-body site indices


def site_table(bodies) -> Optional[SiteTable]:
    """The site table, or None when no body carries nucleation sites."""
    sites, coms, gids, sids = [], [], [], []
    for g in bd.as_buckets(bodies):
        ns = g.nucleation_sites_ref.shape[1]
        if ns == 0:
            continue
        dev = g.position.device
        sites.append(bd.place(g)[2].reshape(-1, 3))
        coms.append(torch.repeat_interleave(g.position, ns, dim=0))
        ranks = (g.config_rank if g.config_rank is not None
                 else torch.arange(g.n_bodies, dtype=torch.int32,
                                   device=dev))
        gids.append(torch.repeat_interleave(ranks.to(torch.int32), ns))
        sids.append(torch.arange(ns, dtype=torch.int32,
                                 device=dev).repeat(g.n_bodies))
    if not sites:
        return None
    return SiteTable(torch.cat(sites), torch.cat(coms), torch.cat(gids),
                     torch.cat(sids))


def _stream_key(di_rng, offset: int):
    """The `utils.rng.Stream` key chain: the stream id, then counter +
    ``offset``, folded into the seeded key."""
    seed, stream_id, counter = (int(v) for v in di_rng)
    base = rng_mod.fold_in(rng_mod.seed_key(seed), stream_id)
    return rng_mod.fold_in(base, counter + offset)


def sample_draws(di_rng, lam: float, capacity: int, n_sites: int) -> DIDraws:
    """The natural draws of one round from a member's stream carry
    (seed, stream id, counter): the JAX package's `sample_draws` bit for
    bit (float64 uniforms, the float32 Poisson sampler)."""
    u_cat = rng_mod.uniform(_stream_key(di_rng, 0), capacity, np.float64)
    n_raw = int(rng_mod.poisson(_stream_key(di_rng, 1), max(lam, 0.0),
                                1)[0])
    u_site = rng_mod.uniform(_stream_key(di_rng, 2), max(n_sites, 1),
                             np.float64)
    return DIDraws(u_cat=u_cat, n_raw=n_raw, u_site=u_site[:n_sites])


#: per-fiber fields the slot fill writes (the host path's ``handled`` set)
_HANDLED = {"x", "tension", "length", "length_prev", "bending_rigidity",
            "radius", "penalty", "beta_tstep", "v_growth", "force_scale",
            "minus_clamped", "plus_pinned", "binding_body", "binding_site",
            "active", "config_rank"}


def check_di_state(state, params) -> None:
    """Raise unless ``state`` can run the device DI update: one
    fixed-capacity group at the DI resolution, every per-fiber field one
    the slot fill resets."""
    di = params.dynamic_instability
    fibers = state.fibers
    if fibers is None or not isinstance(fibers, fc.FiberGroup):
        raise ValueError(
            "device dynamic instability needs a single fixed-capacity "
            "FiberGroup (mixed-resolution tuples and fiber-less states "
            "run the host loop; pre-allocate capacity with "
            "scenarios.ensure_di_capacity)")
    if fc.live_node_count(fibers) != di.n_nodes:
        raise ValueError(
            "dynamic_instability.n_nodes must match the fiber group's live "
            f"resolution ({di.n_nodes} != {fc.live_node_count(fibers)})")
    per_fiber = {name for name, leaf in zip(fibers._fields, fibers)
                 if torch.is_tensor(leaf) and leaf.ndim >= 1
                 and leaf.shape[0] == fibers.n_fibers}
    if per_fiber - _HANDLED:
        raise RuntimeError(
            f"device nucleation slot-fill does not reset fiber fields "
            f"{sorted(per_fiber - _HANDLED)}; recycled slots would inherit "
            "dead fibers' values")


def di_update(state, params, di_rng, *, sample_fn=None):
    """One nucleation / catastrophe update -> (new_state, `DIInfo`).

    ``di_rng`` is the member's (seed, stream id, counter); the caller
    advances the counter by `DRAWS_PER_STEP` unless the update needs
    growth. ``sample_fn(di_rng, lam, capacity, n_sites)`` replaces the
    natural draws (`sample_draws`). The arithmetic runs in float64 and
    casts back to the state's dtype; on ``needs_growth`` the state is
    returned unchanged. The phase ``dynamic-instability``
    (`obs.profile.phase`)."""
    with phase("dynamic-instability"):
        return _di_update_impl(state, params, di_rng, sample_fn=sample_fn)


def _di_update_impl(state, params, di_rng, *, sample_fn=None):
    di = params.dynamic_instability
    fibers = state.fibers
    dtype, dev = fibers.x.dtype, fibers.x.device
    f64 = torch.float64
    cap = fibers.n_fibers
    n_live = di.n_nodes
    dt = float(state.dt)

    active = fibers.active
    v_growth, f_cat = di_rates.effective_rates(di, fibers.plus_pinned, torch)
    attached = active & (fibers.binding_body >= 0)
    tab = site_table(state.bodies)
    n_sites = tab.sites.shape[0] if tab is not None else 0
    n_attached, n_active = (int(v) for v in torch.stack(
        [attached.sum(), active.sum()]).tolist())
    lam = di_rates.nucleation_mean(dt, di.nucleation_rate,
                                   float(max(n_sites - n_attached, 0)))
    draws = (sample_fn or sample_draws)(di_rng, lam, cap, n_sites)

    # ---------------------------------------------- catastrophe + growth
    u_cat = torch.as_tensor(draws.u_cat, dtype=f64, device=dev)
    die = di_rates.catastrophe_mask(active, u_cat, dt, f_cat, torch)
    survive = active & ~die
    length64 = fibers.length.to(f64)
    length_prev64 = torch.where(survive, length64, fibers.length_prev.to(f64))
    length64 = di_rates.grown_length(length64, survive, dt, v_growth, torch)
    v_growth64 = torch.where(survive, v_growth, 0.0)
    binding_body = torch.where(survive, fibers.binding_body,
                               torch.full_like(fibers.binding_body, -1))
    grown = fibers._replace(
        active=survive, length=length64.to(dtype),
        length_prev=length_prev64.to(dtype), v_growth=v_growth64.to(dtype),
        binding_body=binding_body)

    if tab is None:
        # catastrophe-only scene: never outgrows its capacity
        n_die, n_surv = (int(v) for v in torch.stack(
            [die.sum(), survive.sum()]).tolist())
        return state._replace(fibers=grown), DIInfo(0, n_die, n_surv, False)

    # ---------------------------------------------------------- nucleation
    # site occupancy from the post-catastrophe bindings: a dying fiber
    # frees its site this very round
    bound = survive & (binding_body >= 0)
    occ = torch.any(bound[None, :]
                    & (binding_body[None, :] == tab.gids[:, None])
                    & (fibers.binding_site[None, :] == tab.sids[:, None]),
                    dim=1)
    n_free, free_slots, n_die = (int(v) for v in torch.stack(
        [(~occ).sum(), (~survive).sum(), die.sum()]).tolist())
    n_want = int(di_rates.nucleation_count(draws.n_raw, n_free))
    if n_want > free_slots:
        return state, DIInfo(0, 0, n_active, True)
    n_fill = n_want

    # the free sites ranked by their priority draws (occupied ones last);
    # the k-th chosen site fills the k-th inactive slot
    u_site = torch.as_tensor(draws.u_site, dtype=f64, device=dev)
    prio = torch.where(occ, torch.inf, u_site)
    order = torch.argsort(prio, stable=True).to(torch.int32)
    slot_rank = (torch.cumsum(~survive, 0) - 1).to(torch.int32)
    fill = (~survive) & (slot_rank < n_fill)
    site_of = order[torch.clamp(slot_rank, 0, n_sites - 1).long()].long()
    origin = tab.sites[site_of].to(f64)
    com = tab.coms[site_of].to(f64)
    nodes = di_rates.nucleated_nodes(origin, com, di.min_length, n_live,
                                     torch)                  # [cap, nl, 3]
    pad = fibers.n_nodes - n_live
    if pad:
        # node-padded groups: the padding rows replicate the first node
        nodes = torch.cat([nodes, nodes[:, :1].expand(-1, pad, -1)], dim=1)
    next_rank = fibers.config_rank.max() + 1

    def sel(new, old):
        m = fill.reshape(fill.shape + (1,) * (old.ndim - 1))
        new = torch.as_tensor(new, dtype=old.dtype, device=dev)
        return torch.where(m, new, old)

    out = grown._replace(
        x=sel(nodes.to(dtype), fibers.x),
        tension=sel(0.0, fibers.tension),
        length=sel(di.min_length, grown.length),
        length_prev=sel(di.min_length, grown.length_prev),
        bending_rigidity=sel(di.bending_rigidity, fibers.bending_rigidity),
        radius=sel(di.radius, fibers.radius),
        penalty=sel(fd_fiber.DEFAULT_PENALTY, fibers.penalty),
        beta_tstep=sel(fd_fiber.DEFAULT_BETA_TSTEP, fibers.beta_tstep),
        v_growth=sel(0.0, grown.v_growth),
        force_scale=sel(0.0, fibers.force_scale),
        minus_clamped=fill | fibers.minus_clamped,
        plus_pinned=~fill & fibers.plus_pinned,
        binding_body=torch.where(fill, tab.gids[site_of], binding_body),
        binding_site=torch.where(fill, tab.sids[site_of],
                                 fibers.binding_site),
        active=survive | fill,
        config_rank=torch.where(fill, (next_rank + slot_rank).to(torch.int32),
                                fibers.config_rank))
    return state._replace(fibers=out), DIInfo(
        n_fill, n_die, cap - free_slots + n_fill, False)


def auditable_programs():
    """The scenarios layer's registry entry: one device DI update over a
    fixture with capacity padding (8 slots, 3 live fibers, one bound to a
    nucleation site of a 40-node sphere), the JAX package's
    ``di_device``."""
    from ..audit.registry import AuditProgram, BuiltProgram

    def build(device=None):
        from ..params import DynamicInstability, Params
        from ..periphery.precompute import precompute_body
        from ..system import System

        params = Params(
            eta=1.0, dt_initial=0.02, dt_write=0.02, t_final=0.08,
            gmres_tol=1e-10, adaptive_timestep_flag=False,
            dynamic_instability=DynamicInstability(
                n_nodes=8, v_growth=0.2, f_catastrophe=0.5,
                nucleation_rate=60.0, min_length=0.4, radius=0.0125,
                bending_rigidity=0.01))
        system = System(params, device=device)
        dev = system.device
        pre = precompute_body("sphere", 40, radius=0.5)
        rng = np.random.default_rng(11)
        sites = rng.standard_normal((6, 3))
        sites = 0.5 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
        bodies = bd.make_group(pre["node_positions_ref"],
                               pre["node_normals_ref"], pre["node_weights"],
                               nucleation_sites_ref=sites[None], radius=0.5,
                               device=dev)
        x = np.tile(np.linspace(0.0, 1.0, 8)[None, :, None], (3, 1, 3))
        x += (1.5 + np.arange(3))[:, None, None]
        g = fc.grow_capacity(fc.make_group(x, lengths=1.0,
                                           bending_rigidity=0.01,
                                           radius=0.0125, device=dev), 8)
        bb, bs = g.binding_body.clone(), g.binding_site.clone()
        bb[0], bs[0] = 0, 0          # occupied site: exercises the bitmap
        g = g._replace(binding_body=bb, binding_site=bs)
        state = system.make_state(fibers=g, bodies=bodies)
        return BuiltProgram(di_update, (state, params, [0, 3, 0]),
                            device=dev)

    return [AuditProgram(
        name="di_device", layer="scenarios",
        summary="device DI update (nucleation/catastrophe mask flips over "
                "an 8-slot capacity batch, 3 live fibers)",
        build=build)]
