"""Dynamic instability: stochastic fiber catastrophe + nucleation.

Counterpart of `skellysim_tpu.system.dynamic_instability`: the host-side
update between solves, the counterpart of the reference's
`System::dynamic_instability` (`dynamic_instability.cpp`):

- each active fiber draws a catastrophe with P = 1 - exp(-dt * f_cat)
  (`:83-84`), with the rates rescaled for plus-pinned fibers (`:76-79`);
  survivors grow by dt * v_growth (`:89-91`);
- nucleation-site occupancy is a flat bitmap over all body sites (`:63,87`);
- the number of new fibers is Poisson(dt * rate * n_inactive_old) capped by
  the free-site count (`:115-116`), each placed on a uniformly drawn free
  site (`:118-126`), pointing radially out of its body (`:178-186`).

Fibers live in a fixed-capacity batch with an ``active`` mask:
catastrophes deactivate slots, nucleations fill inactive slots, and the
capacity grows onto the geometric rungs (`buckets.next_fiber_capacity`).
The update runs in numpy on the host; the draws come from `utils.rng`,
which reproduces the JAX package's stream, so the same state and RNG state
give the same events, slots and positions in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bodies import bodies as bd
from ..fibers import container as fc
from ..fibers import fd_fiber
from ..fibers.matrices import FibMatsRT
from ..utils.rng import SimRNG
from . import buckets, di_rates
from .system import state_placement

#: FiberGroup fields held as int32 / bool on the device
_INT_FIELDS = ("binding_body", "binding_site", "config_rank")


def _np(t) -> np.ndarray:
    """Host copy of a tensor (numpy arrays pass)."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _host_leaves(fibers):
    """The group with every per-fiber tensor as a numpy copy; the
    group-level runtime matrices (`rt_mats`) stay as they are."""
    return type(fibers)(*[v if v is None or isinstance(v, FibMatsRT)
                          else _np(v).copy() for v in fibers])


def _bucket_bindings(groups):
    """(occupied {(gid, site)}, n_bound) over the given fiber groups: fibers
    bind by GLOBAL body id, so occupancy aggregates every bucket (the
    reference's one flat bitmap, `dynamic_instability.cpp:63`)."""
    occupied = set()
    n_bound = 0
    for g in groups:
        if g.n_fibers == 0:
            continue
        bb, bs = _np(g.binding_body), _np(g.binding_site)
        bound = _np(g.active) & (bb >= 0)
        occupied |= set(zip(bb[bound].tolist(), bs[bound].tolist()))
        n_bound += int(bound.sum())
    return occupied, n_bound


def _rank_max(group) -> int:
    return (int(group.config_rank.max()) if group.config_rank is not None
            and group.config_rank.numel() else -1)


def apply_dynamic_instability(state, params, rng: SimRNG,
                              node_multiple: int = 1, stats: dict | None = None,
                              _extra_occupied=None,
                              _extra_bound: int = 0, _rank_floor: int = -1):
    """One nucleation/catastrophe update; returns a new SimState.

    With several resolution buckets, the bucket whose resolution matches
    `dynamic_instability.n_nodes` takes the events; the others pass through,
    but their site occupancy, bound-fiber count and config ranks feed the
    global bookkeeping. ``node_multiple`` (the ring mesh's size) keeps the
    grown capacity's node count divisible by it. ``stats`` (optional dict)
    is filled with this update's ``catastrophes`` / ``nucleations`` counts.
    """
    di = params.dynamic_instability
    if stats is not None:
        stats.setdefault("catastrophes", 0)
        stats.setdefault("nucleations", 0)
    if di.n_nodes == 0:
        return state
    if (state.fibers is not None
            and not isinstance(state.fibers, fc.FiberGroup)):
        groups = list(fc.as_buckets(state.fibers))
        idx = next((i for i, g in enumerate(groups)
                    if fc.live_node_count(g) == di.n_nodes), None)
        if idx is None:
            raise NotImplementedError(
                f"dynamic_instability.n_nodes={di.n_nodes} matches no fiber "
                f"bucket (resolutions: {[g.n_nodes for g in groups]}); add "
                "an (empty-capacity) bucket at that resolution")
        others = [g for i, g in enumerate(groups) if i != idx]
        occ, n_bound = _bucket_bindings(others)
        rank_floor = max((_rank_max(g) for g in others), default=-1)
        sub = apply_dynamic_instability(
            state._replace(fibers=groups[idx]), params, rng,
            node_multiple, stats=stats,
            _extra_occupied=occ, _extra_bound=n_bound,
            _rank_floor=rank_floor)
        groups[idx] = sub.fibers
        return state._replace(fibers=tuple(groups))
    dtype, device = state_placement(state)
    fibers = state.fibers
    bodies = state.bodies
    dt = float(state.dt)

    if fibers is not None and fc.live_node_count(fibers) != di.n_nodes:
        # the LIVE resolution: a node-padded bucket nucleates at it
        raise NotImplementedError(
            "dynamic_instability.n_nodes must match the fiber group's live "
            f"resolution ({di.n_nodes} != {fc.live_node_count(fibers)}); "
            "use a tuple of buckets for mixed resolutions")
    if fibers is not None:
        fibers = _host_leaves(fibers)

    # ---------------------------------------------- catastrophe + growth
    if fibers is not None and fibers.n_fibers > 0:
        nf = fibers.n_fibers
        active = fibers.active.copy()
        v_growth, f_cat = di_rates.effective_rates(di, fibers.plus_pinned,
                                                   np)
        n_active_old = int((active & (fibers.binding_body >= 0)).sum())

        u = rng.distributed.uniform(size=nf)
        die = di_rates.catastrophe_mask(active, u, dt, f_cat, np)
        survive = active & ~die
        if stats is not None:
            stats["catastrophes"] += int(die.sum())

        length = fibers.length
        length_prev = np.where(survive, length, fibers.length_prev)
        length = di_rates.grown_length(length, survive, dt, v_growth, np)
        fibers = fibers._replace(
            active=survive, length=length, length_prev=length_prev,
            v_growth=np.where(survive, v_growth, 0.0),
            binding_body=np.where(survive, fibers.binding_body, -1))
    else:
        n_active_old = 0

    # ---------------------------------------------------------- nucleation
    site_tab = host_site_table(bodies)
    if not site_tab:
        return state._replace(fibers=_as_device(fibers, dtype, device))
    n_sites = len(site_tab)

    occupied = set(_extra_occupied or ())
    if fibers is not None and fibers.n_fibers > 0:
        bound = fibers.active & (fibers.binding_body >= 0)
        occupied |= set(zip(fibers.binding_body[bound].tolist(),
                            fibers.binding_site[bound].tolist()))

    free_sites = [k for k, (gid, s_i, _, _) in enumerate(site_tab)
                  if (gid, s_i) not in occupied]
    n_inactive_old = n_sites - n_active_old - _extra_bound
    n_nucleate = int(di_rates.nucleation_count(
        rng.distributed.poisson_int(
            di_rates.nucleation_mean(dt, di.nucleation_rate, n_inactive_old)),
        len(free_sites)))

    # sequential uniform draws without replacement
    # (`dynamic_instability.cpp:118-126`)
    chosen = []
    pool = list(free_sites)
    for _ in range(n_nucleate):
        j = rng.distributed.uniform_int(0, len(pool))
        chosen.append(pool.pop(j))
    if not chosen:
        return state._replace(fibers=_as_device(fibers, dtype, device))

    new_x, new_body, new_site = [], [], []
    for flat in chosen:
        gid, i_site, origin, com = site_tab[int(flat)]
        new_x.append(di_rates.nucleated_nodes(origin, com, di.min_length,
                                              di.n_nodes, np))
        new_body.append(gid)
        new_site.append(i_site)
    if stats is not None:
        stats["nucleations"] += len(chosen)

    if fibers is None or fibers.n_fibers == 0:
        fibers = fc.make_group(
            np.stack(new_x), lengths=di.min_length,
            bending_rigidity=di.bending_rigidity, radius=di.radius,
            minus_clamped=True, binding_body=np.array(new_body),
            binding_site=np.array(new_site),
            config_rank=_rank_floor + 1 + np.arange(len(new_x)),
            dtype=dtype, device=device)
        # from-scratch groups land on the same geometric rungs as growth
        fibers = fc.grow_capacity(
            fibers, buckets.next_fiber_capacity(fibers.n_fibers),
            node_multiple)
        return state._replace(fibers=fibers)

    # fill inactive slots; grow the capacity onto the next geometric rung
    # when out of room (`fc.grow_capacity` lays the new slots out as the
    # JAX package does, so per-slot draws land on the same fibers)
    slots = np.flatnonzero(~fibers.active)
    if slots.size < len(chosen):
        need = int(fibers.active.sum()) + len(chosen)
        grown = fc.grow_capacity(_as_device(fibers, dtype, device),
                                 buckets.next_fiber_capacity(need),
                                 node_multiple)
        fibers = _host_leaves(grown)
        slots = np.flatnonzero(~fibers.active)
    slots = slots[:len(chosen)]

    arr = {k: v for k, v in fibers._asdict().items() if k != "rt_mats"}
    handled = {"x", "tension", "length", "length_prev", "bending_rigidity",
               "radius", "penalty", "beta_tstep", "v_growth", "force_scale",
               "minus_clamped", "plus_pinned", "binding_body", "binding_site",
               "active", "config_rank"}
    if set(arr) - handled:
        raise RuntimeError(
            f"nucleation slot-fill does not reset fiber fields "
            f"{set(arr) - handled}; recycled slots would inherit dead "
            "fibers' values")
    # fresh config ranks: nucleated fibers append after every existing
    # fiber in the trajectory's config order, across all buckets
    next_rank = max(int(arr["config_rank"].max(initial=-1)), _rank_floor) + 1
    # node-padded groups: the nucleated geometry fills the live prefix and
    # the padding rows replicate its first node (`fc.grow_node_capacity`)
    n_cap = fibers.x.shape[1]
    if n_cap > di.n_nodes:
        new_x = [np.concatenate(
            [xr, np.repeat(xr[:1], n_cap - di.n_nodes, axis=0)], axis=0)
            for xr in new_x]
    for k, slot in enumerate(slots):
        arr["config_rank"][slot] = next_rank + k
        arr["x"][slot] = new_x[k]
        arr["tension"][slot] = 0.0
        arr["length"][slot] = di.min_length
        arr["length_prev"][slot] = di.min_length
        arr["bending_rigidity"][slot] = di.bending_rigidity
        arr["radius"][slot] = di.radius
        arr["penalty"][slot] = fd_fiber.DEFAULT_PENALTY
        arr["beta_tstep"][slot] = fd_fiber.DEFAULT_BETA_TSTEP
        arr["v_growth"][slot] = 0.0
        arr["force_scale"][slot] = 0.0
        arr["minus_clamped"][slot] = True
        arr["plus_pinned"][slot] = False
        arr["binding_body"][slot] = new_body[k]
        arr["binding_site"][slot] = new_site[k]
        arr["active"][slot] = True
    return state._replace(fibers=_as_device(fibers._replace(**arr), dtype,
                                            device))


def host_site_table(bodies) -> list:
    """Flat ``[(global_id, site_index, origin, com)]`` nucleation-site table
    across every body bucket: bucket-concatenated, body-major, site-minor
    (the reference's flat bitmap over all sites); fibers bind by GLOBAL body
    id (`BodyGroup.config_rank`)."""
    tab = []
    for g in bd.as_buckets(bodies):
        ns_b = g.nucleation_sites_ref.shape[1]
        if ns_b == 0:
            continue
        sites_lab = _np(bd.place(g)[2])          # [nb, ns_b, 3]
        pos = _np(g.position)
        ranks = (_np(g.config_rank) if g.config_rank is not None
                 else np.arange(g.n_bodies))
        for lb in range(g.n_bodies):
            for s_i in range(ns_b):
                tab.append((int(ranks[lb]), s_i, sites_lab[lb, s_i], pos[lb]))
    return tab


def _count_active(fibers) -> int:
    """Live fiber count over every bucket (the `active_fibers` metrics
    field)."""
    return sum(int(g.active.sum()) for g in fc.as_buckets(fibers))


def _as_device(fibers, dtype, device):
    """numpy-edited leaves back on the state's device: floats in the state
    dtype, the port's int32 integer fields, bool masks."""
    if fibers is None:
        return None

    def conv(name, leaf):
        if leaf is None:
            return None
        if isinstance(leaf, FibMatsRT):
            return leaf.to(dtype, device)
        leaf = np.asarray(leaf)
        kind = (torch.int32 if name in _INT_FIELDS
                else torch.bool if leaf.dtype == bool else dtype)
        return torch.as_tensor(leaf, dtype=kind, device=device)

    return type(fibers)(*[conv(n, v) for n, v in zip(fibers._fields, fibers)])
