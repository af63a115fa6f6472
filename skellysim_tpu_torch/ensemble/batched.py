"""One batched trial over B stacked members: the ensemble's ``"vmap"`` plan.

Where the JAX package lifts `System.trial_step` over the member axis with
`jax.vmap`, this module writes the batched trial out: the prep, the coupled
operator, the preconditioner and the advance of `system.System`, each over
B members at once.

* Fibers and bodies are independent rows, so the member axis folds into the
  fiber and body axes: a member batch of [B, nf, ...] groups is one group of
  B nf fibers (and B nb bodies) for every per-fiber and per-body operation
  (caches, BC rows, LU factors and solves, matvecs, the advance). Each
  member keeps its own dt (a value a fiber, `fd_fiber._per_fiber`) and
  clock.
* The shell's dense operators act member by member (one matrix-vector
  product a member, `_member_mv`: the solo step's bits of those rows).
* Every pair sum is one member-batched launch a family
  (`ops.kernels.stokeslet_direct` / `stresslet_direct` with a leading [B]:
  kernels A-D over the member axis on the card), its targets and sources
  the member's own. A spectral plan sums member by member through it.
* The solve is `solver.gmres_batched` / `gmres_ir_batched`: each member its
  own Krylov state, one host read an Arnoldi step (or, with
  ``gmres_block_s > 1``, a Gram pass of an s-step round) for all members.

The stacked state (`ensemble.runner.stack_states`) keeps the member axis
leading on every tensor; ``time`` and ``dt`` are float64 numpy arrays [B].
A member's result agrees with its solo `System.trial_step` to roundoff, as
the JAX package's vmap plan does (batched products and the member-batched
kernel plans sum in another order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bodies import bodies as bd
from ..fibers import container as fc
from ..fibers import fd_fiber
from ..fibers.matrices import FibMatsRT
from ..guard import verdict as _verdict
from ..obs.profile import phase
from ..ops import kernels
from ..solver import gmres_batched, gmres_ir_batched
from ..system.system import StepInfo, _cast_floats


def _buckets(field):
    """A stacked fibers / bodies field as a list of buckets."""
    if field is None:
        return []
    if isinstance(field, (fc.FiberGroup, bd.BodyGroup)):
        return [field]
    return list(field)


def _rewrap(field, buckets):
    if isinstance(field, (fc.FiberGroup, bd.BodyGroup)):
        return buckets[0]
    return tuple(buckets)


def _fold(group, B: int):
    """A stacked group ([B, k, ...] leaves) as one group of B k rows (the
    member axis folded into the fiber / body axis); runtime node matrices,
    shared by the members of a bucket, are taken once."""
    def fold(name, leaf):
        if leaf is None:
            return None
        if isinstance(leaf, FibMatsRT):
            if not all(torch.equal(t, t[:1].expand_as(t)) for t in leaf):
                raise NotImplementedError(
                    "members of different live fiber resolutions in one "
                    "node bucket need batch_impl='unroll'")
            return FibMatsRT(*[t[0] for t in leaf])
        return leaf.reshape((-1,) + tuple(leaf.shape[2:]))

    return type(group)(*[fold(n, v) for n, v in zip(group._fields, group)])


def _unfold(group, stacked):
    """The folded ``group`` back in ``stacked``'s [B, k, ...] layout."""
    B = len(stacked.x) if isinstance(stacked, fc.FiberGroup) else \
        len(stacked.position)

    def unfold(name, leaf, ref):
        if leaf is None:
            return None
        if isinstance(leaf, FibMatsRT):
            return ref
        return leaf.reshape((B, -1) + tuple(leaf.shape[1:]))

    return type(group)(*[unfold(n, v, r) for n, v, r in
                         zip(group._fields, group, stacked)])


def _lane(obj, i):
    """Member ``i`` of a stacked NamedTuple of tensors."""
    if obj is None:
        return None
    return type(obj)(*[_lane(v, i) if isinstance(v, tuple)
                       else (None if v is None else v[i]) for v in obj])


class BatchedTrial:
    """The batched trial of ``system`` over stacked member states."""

    def __init__(self, system):
        self.system = system
        self.params = system.params

    # ------------------------------------------------------------ layout

    def _layout(self, st):
        """Per member: node counts (fibers, shell, bodies) and solution
        sizes, from the stacked state."""
        fib = _buckets(st.fibers)
        bod = _buckets(st.bodies)
        nfn = sum(g.x.shape[1] * g.x.shape[2] for g in fib)
        nsn = st.shell.nodes.shape[1] if st.shell is not None else 0
        nbn = sum(g.nodes_ref.shape[1] * g.nodes_ref.shape[2] for g in bod)
        fsz = sum(4 * g.x.shape[1] * g.x.shape[2] for g in fib)
        return nfn, nsn, nbn, fsz, 3 * nsn

    def _split(self, fib, bod, x, fsz, ssz):
        """[B, n] solutions -> (folded [B nf, 4n] fiber blocks a bucket,
        [B, 3N] shell part, folded [B nb, 3n + 6] body blocks a bucket)."""
        B = x.shape[0]
        fibs, off = [], 0
        for g in fib:
            nf, n = g.n_fibers // B, g.n_nodes
            fibs.append(x[:, off:off + nf * 4 * n].reshape(B * nf, 4 * n))
            off += nf * 4 * n
        x_shell = x[:, fsz:fsz + ssz]
        bods, off = [], fsz + ssz
        for g in bod:
            nb, n = g.n_bodies // B, g.n_nodes
            bods.append(x[:, off:off + nb * (3 * n + 6)].reshape(
                B * nb, 3 * n + 6))
            off += nb * (3 * n + 6)
        return fibs, x_shell, bods

    # --------------------------------------------------------- pair sums

    def _fiber_flow(self, B, fib, caches, r_all, forces, impl, pair,
                    stacked):
        """The member-batched `container.flow_multi` with the self
        subtraction: sources every member's fiber nodes, targets ``r_all``
        [B, T, 3] whose leading rows are those nodes. A fast ``pair`` sums
        member by member (``stacked``: the fiber buckets in their stacked
        layout, to unfold the members)."""
        eta = self.params.eta
        if pair is not None:
            return torch.stack([fc.flow_multi(
                [_lane(_unfold(g, s), i) for g, s in zip(fib, stacked)],
                [_lane_caches(c, B, i) for c in caches], r_all[i],
                [f.reshape(B, -1, *f.shape[1:])[i] for f in forces], eta,
                impl=impl, pair=pair.at("fibers")) for i in range(B)])
        pos = torch.cat([fc.node_positions(g).reshape(B, -1, 3)
                         for g in fib], dim=1)
        wf = torch.cat([fc.weighted_forces(g, f).reshape(B, -1, 3)
                        for g, f in zip(fib, forces)], dim=1)
        act = torch.cat([fc.node_active_flat(g).reshape(B, -1)
                         for g in fib], dim=1)
        pos = torch.where(act[..., None], pos, 0.0)
        nfn = pos.shape[1]
        r_trg = torch.cat([pos, r_all[:, nfn:]], dim=1)
        vel = kernels.stokeslet_direct(pos, r_trg, wf, eta, impl=impl)
        off = 0
        for g, c in zip(fib, caches):
            nfn_g = g.n_fibers * g.n_nodes // B
            self_vel = torch.bmm(c.stokeslet,
                                 wf[:, off:off + nfn_g].reshape(
                                     g.n_fibers, -1, 1))
            vel[:, off:off + nfn_g] -= self_vel.reshape(B, -1, 3)
            off += nfn_g
        return vel

    def _shell_flow(self, B, shell, r_trg, density, impl, pair):
        """The shell's double layer at ``r_trg`` [B, T, 3] from each
        member's density [B, 3N]."""
        eta = self.params.eta
        rho = density.reshape(B, -1, 3)
        f_dl = 2.0 * eta * shell.normals[..., None] * rho[:, :, None, :]
        if (pair is not None
                and shell.nodes.shape[1] >= self.params.ewald_min_sources):
            p = pair.at("shell")
            return torch.stack([p.stresslet(shell.nodes[i], r_trg[i],
                                            f_dl[i], eta, impl)
                                for i in range(B)])
        return kernels.stresslet_direct(shell.nodes, r_trg, f_dl, eta,
                                        impl=impl)

    def _body_flow(self, B, g, bc, r_all, x_b, ft, impl, pair, index):
        """`bodies.flow` member by member in one launch a family: the node
        double layer (``x_b`` None skips it), the COM Stokeslet and the
        rotlet of each member's bodies at its own targets."""
        eta = self.params.eta
        nb, n = g.n_bodies // B, g.n_nodes
        if x_b is None:
            v = torch.zeros_like(r_all)
        else:
            dens = x_b[:, :3 * n].reshape(B, nb * n, 3)
            normals = bc.normals.reshape(B, nb * n, 3)
            f_dl = 2.0 * eta * normals[..., None] * dens[:, :, None, :]
            nodes = bc.nodes.reshape(B, nb * n, 3)
            use_pair = (pair is not None
                        and nb * n >= self.params.ewald_min_sources)
            if use_pair:
                p = pair.at("body", index)
                v = torch.stack([p.stresslet(nodes[i], r_all[i], f_dl[i],
                                             eta, impl) for i in range(B)])
            else:
                v = kernels.stresslet_direct(nodes, r_all, f_dl, eta,
                                             impl=impl)
        pos = g.position.reshape(B, nb, 3)
        ft = ft.reshape(B, nb, 6)
        v = v + kernels.stokeslet_direct(pos, r_all, ft[..., :3], eta)
        rot = torch.stack([kernels.rotlet(pos[i], r_all[i], ft[i, :, 3:],
                                          eta) for i in range(B)])
        return v + rot

    def _external(self, st, r_all):
        """Point-source and background flows, member by member (each at its
        own time)."""
        p = self.params
        v = torch.zeros_like(r_all)
        for i in range(r_all.shape[0]):
            if st.points is not None:
                v[i] += _lane(st.points, i).flow(r_all[i], p.eta,
                                                 float(st.time[i]))
            if st.background is not None:
                v[i] += _lane(st.background, i).flow(r_all[i], p.eta)
        return v

    # ------------------------------------------------------------- pieces

    @staticmethod
    def _local_binding(fibers, gb, B: int, nbt: int):
        """`bodies.local_binding` over folded members: a fiber bound to a
        body of bucket ``gb`` gets its folded row (member offset
        included)."""
        dev = fibers.binding_body.device
        nb, nf = gb.n_bodies // B, fibers.n_fibers // B
        lookup = torch.full((B, max(nbt, 1)), -1, dtype=torch.int32,
                            device=dev)
        rows = (torch.arange(nb, device=dev)[None, :]
                + nb * torch.arange(B, device=dev)[:, None])
        lookup.scatter_(1, gb.config_rank.reshape(B, nb).long(),
                        rows.to(torch.int32))
        bb = fibers.binding_body.reshape(B, nf)
        local = torch.where(
            bb >= 0,
            torch.gather(lookup, 1, torch.clamp(bb, 0, nbt - 1).long()),
            -1).to(torch.int32)
        return fibers._replace(binding_body=local.reshape(-1))

    def _nodes(self, B, fib, shell, bcaches):
        parts = [fc.node_positions(g).reshape(B, -1, 3) for g in fib]
        if shell is not None:
            parts.append(shell.nodes)
        parts += [c.nodes.reshape(B, -1, 3) for c in bcaches]
        return torch.cat(parts, dim=1)

    def _prep(self, st, fib, bod, dt_f, time_f, time_b, pair):
        """`System._prep` over the batch: (fibers, caches, body caches,
        [B, n] RHS)."""
        p = self.params
        sys_ = self.system
        B = len(st.time)
        lane0 = self._lane0
        precision = sys_._precision_for(lane0)
        precond_dtype = torch.float32 if precision == "mixed" else None
        refine_prep = (precision == "mixed"
                       and sys_._dtype(lane0) == torch.float64)
        impl_flow = sys_._refine_impl if refine_prep else p.kernel_impl
        prep_pair = sys_._refine_pair(pair) if refine_prep else pair

        folded = st._replace(fibers=_rewrap(st.fibers, fib) if fib else None)
        fib = _buckets(sys_._update_plus_pinning(folded).fibers)
        bcaches = [bd.update_cache(g, p.eta, precond_dtype=precond_dtype)
                   for g in bod]
        r_all = self._nodes(B, fib, st.shell, bcaches)
        nfn, nsn = self._counts[:2]
        v_all = torch.zeros_like(r_all)
        caches = motor = external = None
        if fib:
            caches = [fc.update_cache(g, None, p.eta) for g in fib]
            external = sys_._periphery_force_fibers(
                st._replace(fibers=_rewrap(st.fibers, fib)))
            motor = [torch.where(
                (t >= p.implicit_motor_activation_delay)[:, None, None],
                fc.generate_constant_force(g, c), torch.zeros_like(g.x))
                for g, c, t in zip(fib, caches, time_f)]
            v_all = v_all + self._fiber_flow(B, fib, caches, r_all, external,
                                             impl_flow, prep_pair,
                                             _buckets(st.fibers))
        for j, (g, bc) in enumerate(zip(bod, bcaches)):
            ext = bd.external_forces_torques(g, time_b[j])
            v_all = v_all + self._body_flow(B, g, bc, r_all, None, ext,
                                            impl_flow, None, j)
        if st.points is not None or st.background is not None:
            v_all = v_all + self._external(st, r_all)

        rhs = []
        if fib:
            off = 0
            new_caches = []
            for g, c, mo, ex, dt in zip(fib, caches, motor, external, dt_f):
                nfn_g = g.n_fibers * g.n_nodes // B
                v_fib = v_all[:, off:off + nfn_g].reshape(g.n_fibers,
                                                          g.n_nodes, 3)
                new_caches.append(fc.update_rhs_and_bc(
                    g, c, dt, p.eta, v_fib, mo + ex, ex,
                    precond_dtype=precond_dtype))
                off += nfn_g
            caches = new_caches
            rhs += [c.RHS.reshape(B, -1) for c in caches]
        if st.shell is not None:
            v_sh = v_all[:, nfn:nfn + nsn]
            if st.shell.node_mask is not None:
                v_sh = torch.where(st.shell.node_mask[..., None], v_sh, 0.0)
            rhs.append(-v_sh.reshape(B, -1))
        off = nfn + nsn
        for g in bod:
            nbn = g.n_bodies * g.n_nodes // B
            rhs.append(bd.update_RHS(g, v_all[:, off:off + nbn].reshape(
                g.n_bodies, g.n_nodes, 3)).reshape(B, -1))
            off += nbn
        return fib, caches, bcaches, torch.cat(rhs, dim=1)

    def _lo_view(self, st, fib, caches, bod, bcaches):
        """`System._lo_view` over the batch: float32 copies of what the f32
        operator reads."""
        f32 = torch.float32
        has_shell = st.shell is not None
        lo_fib = [_cast_floats(g, f32) for g in fib]
        lo_caches = None if caches is None else [
            fc.FiberCaches(xs=c.xs.to(f32) if has_shell else None, xss=None,
                           xsss=None, xssss=None,
                           stokeslet=c.stokeslet.to(f32),
                           A_bc=c.A_bc.to(f32) if has_shell else None,
                           lu=c.lu, piv=c.piv) for c in caches]
        shell = None if st.shell is None else _cast_floats(st.shell, f32)
        lo_bod = [_cast_floats(g, f32) for g in bod]
        lo_bc = [_cast_floats(c, f32) for c in bcaches]
        return lo_fib, lo_caches, shell, lo_bod, lo_bc

    def _matvec(self, st, fib, caches, bod, bcaches, x, lo=None,
                flow_impl=None, pair=None):
        """`System._apply_matvec` over the batch: x [B, n] -> A x."""
        p = self.params
        if flow_impl is None:
            flow_impl = p.kernel_impl
        B = x.shape[0]
        nfn, nsn, nbn, fsz, ssz = self._counts
        f_fib, f_caches, f_shell, f_bod, f_bc = (
            (fib, caches, st.shell, bod, bcaches) if lo is None else lo)
        hi_dtype = x.dtype
        lo_dtype = hi_dtype if lo is None else torch.float32
        r_all = self._nodes(B, f_fib, f_shell, f_bc)
        v_all = torch.zeros_like(r_all)
        x_fibs, x_shell, x_bods = self._split(fib, bod, x, fsz, ssz)
        if fib:
            fws = [fc.apply_fiber_force(g, c, xf)
                   for g, c, xf in zip(fib, caches, x_fibs)]
            v_all = v_all + self._fiber_flow(
                B, f_fib, f_caches, r_all, [fw.to(lo_dtype) for fw in fws],
                flow_impl, pair, _buckets(st.fibers))
        if st.shell is not None and (fib or bod):
            r_fb = torch.cat([r_all[:, :nfn], r_all[:, nfn + nsn:]], dim=1)
            v_s = self._shell_flow(B, f_shell, r_fb, x_shell.to(lo_dtype),
                                   flow_impl, pair)
            v_all[:, :nfn] += v_s[:, :nfn]
            v_all[:, nfn + nsn:] += v_s[:, nfn:]

        v_boundaries = [torch.zeros((g.n_fibers, 7), dtype=hi_dtype,
                                    device=x.device) for g in fib]
        if bod:
            nbt = sum(g.n_bodies // B for g in bod)
            body_fts = [torch.zeros((g.n_bodies, 6), dtype=hi_dtype,
                                    device=x.device) for g in bod]
            for j, (gb, bc, xb) in enumerate(zip(bod, bcaches, x_bods)):
                for i, (gf, c, xf) in enumerate(zip(fib, caches, x_fibs)):
                    vb, ft = bd.link_conditions(
                        gb, bc, self._local_binding(gf, gb, B, nbt), c, xf,
                        xb)
                    v_boundaries[i] = v_boundaries[i] + vb
                    body_fts[j] = body_fts[j] + ft
            for j, (f_gb, f_bcj, xb, ft) in enumerate(zip(f_bod, f_bc, x_bods,
                                                          body_fts)):
                v_all = v_all + self._body_flow(
                    B, f_gb, f_bcj, r_all, xb.to(lo_dtype),
                    ft.to(lo_dtype), flow_impl, pair, j)

        res, off = [], 0
        for g, c, xf, vb in zip(fib, caches, x_fibs, v_boundaries):
            nfn_g = g.n_fibers * g.n_nodes // B
            v_fib = v_all[:, off:off + nfn_g].reshape(
                g.n_fibers, g.n_nodes, 3).to(hi_dtype)
            res.append(fc.matvec(g, c, xf, v_fib, vb).reshape(B, -1))
            off += nfn_g
        if st.shell is not None:
            v_sh = v_all[:, nfn:nfn + nsn]
            if f_shell.node_mask is not None:
                v_sh = torch.where(f_shell.node_mask[..., None], v_sh, 0.0)
            res.append((_member_mv(f_shell.stresslet_plus_complementary,
                                   x_shell.to(lo_dtype))
                        + v_sh.reshape(B, -1)).to(hi_dtype))
        off = nfn + nsn
        for f_gb, f_bcj, xb in zip(f_bod, f_bc, x_bods):
            nbn_g = f_gb.n_bodies * f_gb.n_nodes // B
            v_b = v_all[:, off:off + nbn_g].reshape(f_gb.n_bodies,
                                                    f_gb.n_nodes, 3)
            res.append(bd.matvec(f_gb, f_bcj, xb.to(lo_dtype), v_b)
                       .to(hi_dtype).reshape(B, -1))
            off += nbn_g
        return torch.cat(res, dim=1)

    def _precond(self, st, fib, caches, shell, bod, bcaches, x, pair=None):
        """`System._apply_precond` over the batch (its phase ``precond``)."""
        with phase("precond"):
            return self._precond_impl(st, fib, caches, shell, bod, bcaches,
                                      x, pair)

    def _precond_impl(self, st, fib, caches, shell, bod, bcaches, x, pair):
        B = x.shape[0]
        nfn, nsn, nbn, fsz, ssz = self._counts
        x_fibs, x_shell, x_bods = self._split(fib, bod, x, fsz, ssz)
        y_shell = v_corr = None
        if shell is not None:
            y_shell = _member_mv(shell.M_inv, x_shell.to(
                shell.M_inv.dtype)).to(x.dtype)
            if self.params.precond == "gs" and nfn + nbn > 0:
                r_all = self._nodes(B, fib, shell, bcaches)
                r_fb = torch.cat([r_all[:, :nfn], r_all[:, nfn + nsn:]],
                                 dim=1)
                v_corr = self._shell_flow(
                    B, shell, r_fb, y_shell.to(shell.nodes.dtype),
                    self.params.kernel_impl, pair)
        res, off_v = [], 0
        for g, c, xf in zip(fib, caches or [], x_fibs):
            if v_corr is not None:
                nfn_g = g.n_fibers * g.n_nodes // B
                v_fib = v_corr[:, off_v:off_v + nfn_g].reshape(
                    g.n_fibers, g.n_nodes, 3)
                ld = g.x.dtype
                xf = xf - fc.matvec(
                    g, c, torch.zeros_like(xf, dtype=ld), v_fib.to(ld),
                    torch.zeros((g.n_fibers, 7), dtype=ld,
                                device=xf.device)).to(xf.dtype)
                off_v += nfn_g
            res.append(fc.apply_preconditioner(g, c, xf).reshape(B, -1))
        if y_shell is not None:
            res.append(y_shell)
        for g, bc, xb in zip(bod, bcaches, x_bods):
            if v_corr is not None:
                nbn_g = g.n_bodies * g.n_nodes // B
                v_b = v_corr[:, off_v:off_v + nbn_g].reshape(
                    g.n_bodies, g.n_nodes, 3)
                ld = bc.K.dtype
                xb = xb - bd.matvec(g, bc, torch.zeros_like(xb, dtype=ld),
                                    v_b.to(ld)).to(xb.dtype)
                off_v += nbn_g
            res.append(bd.apply_preconditioner(g, bc, xb).reshape(B, -1))
        return torch.cat(res, dim=1)

    # --------------------------------------------------------------- trial

    def __call__(self, st, pair=None, block_s=None, force_full=False):
        """(new stacked state, solutions [B, n], [StepInfo] a member) of
        one trial of every member at its own dt. ``block_s`` /
        ``force_full``: the guard ladder's overrides, as in
        `System._solve_once`."""
        from .runner import lane_state

        p = self.params
        sys_ = self.system
        B = len(st.time)
        self._lane0 = lane_state(st, 0)
        self._counts = self._layout(st)
        dtype = sys_._dtype(self._lane0)
        dev = sys_.device
        # the phases of System._solve_once (`obs.profile.phase`)
        with phase("prep"):
            fib = [_fold(g, B) for g in _buckets(st.fibers)]
            bod = [_fold(g, B) for g in _buckets(st.bodies)]

            def per_row(values, rows_a_member):
                return torch.as_tensor(np.repeat(values, rows_a_member),
                                       dtype=dtype, device=dev)

            dt_f = [per_row(st.dt, g.n_fibers // B) for g in fib]
            time_f = [per_row(st.time, g.n_fibers // B) for g in fib]
            dt_b = [per_row(st.dt, g.n_bodies // B)[:, None] for g in bod]
            time_b = [per_row(st.time, g.n_bodies // B) for g in bod]
            fib, caches, bcaches, rhs = self._prep(st, fib, bod, dt_f, time_f,
                                                   time_b, pair)
        bs = p.gmres_block_s if block_s is None else block_s
        precision = ("full" if force_full
                     else sys_._precision_for(self._lane0))
        with phase("gmres"):
            if precision == "mixed":
                lo = self._lo_view(st, fib, caches, bod, bcaches)
                hi_impl = (sys_._refine_impl if dtype == torch.float64
                           else p.kernel_impl)
                refine_pair = sys_._refine_pair(pair)
                result = gmres_ir_batched(
                    lambda v: self._matvec(st, fib, caches, bod, bcaches, v,
                                           flow_impl=hi_impl,
                                           pair=refine_pair),
                    lambda v: self._matvec(st, fib, caches, bod, bcaches, v,
                                           lo=lo, pair=pair),
                    rhs,
                    precond_lo=lambda v: self._precond(
                        st, lo[0], lo[1], lo[2], lo[3], lo[4], v, pair=pair),
                    tol=p.gmres_tol, inner_tol=p.inner_tol,
                    restart=p.gmres_restart, maxiter=p.gmres_maxiter,
                    max_refine=p.max_refine, history=p.gmres_history,
                    block_s=bs)
            else:
                result = gmres_batched(
                    lambda v: self._matvec(st, fib, caches, bod, bcaches, v,
                                           pair=pair),
                    rhs,
                    precond=lambda v: self._precond(
                        st, fib, caches, st.shell, bod, bcaches, v,
                        pair=pair),
                    tol=p.gmres_tol, restart=p.gmres_restart,
                    maxiter=p.gmres_maxiter, history=p.gmres_history,
                    block_s=bs)
        with phase("advance"):
            new = self._advance(st, fib, bod, result.x, dt_b)
            return new, result.x, self._infos(st, new, result)

    def _advance(self, st, fib, bod, x, dt_b):
        """`System._solve_once`'s advance over the batch."""
        B = x.shape[0]
        nfn, nsn, nbn, fsz, ssz = self._counts
        x_fibs, x_shell, x_bods = self._split(fib, bod, x, fsz, ssz)
        new_fib = [fc.step(g, xf) for g, xf in zip(fib, x_fibs)]
        new = st
        if st.shell is not None:
            new = new._replace(shell=st.shell._replace(
                density=x_shell.clone()))
        if bod:
            new_b = [bd.step(g, xb, dt) for g, xb, dt in zip(bod, x_bods,
                                                             dt_b)]
            if new_fib:
                nbt = sum(g.n_bodies // B for g in new_b)
                for gb in new_b:
                    sites = bd.place(gb)[2]
                    new_fib = [g._replace(x=bd.repin_to_bodies(
                        self._local_binding(g, gb, B, nbt), sites, gb).x)
                        for g in new_fib]
            new = new._replace(bodies=_rewrap(st.bodies, [
                _unfold(g, s) for g, s in zip(new_b, _buckets(st.bodies))]))
        if new_fib:
            new = new._replace(fibers=_rewrap(st.fibers, [
                _unfold(g, s) for g, s in zip(new_fib, _buckets(st.fibers))]))
        self._new_fib = new_fib
        return new

    def _infos(self, st, new, result):
        """A `StepInfo` a member (one host read of the fiber errors)."""
        p = self.params
        B = len(st.time)
        errs = []
        for g in self._new_fib:
            e = fd_fiber.fiber_error(g.x, g.length, g.mats)
            e = torch.where(g.active, e, -torch.inf).reshape(B, -1)
            errs.append(torch.clamp_min(torch.amax(e, dim=1), 0.0))
        fiber_error = (torch.stack(errs).amax(dim=0).tolist() if errs
                       else [0.0] * B)
        infos = []
        for i in range(B):
            r = result.member(i)
            fe = fiber_error[i]
            infos.append(StepInfo(
                converged=bool(r.converged), iters=r.iters,
                residual=r.residual, fiber_error=fe,
                residual_true=r.residual_true,
                loss_of_accuracy=bool(r.converged and r.residual_true
                                      > 10.0 * p.gmres_tol),
                refines=r.refines, cycles=r.cycles, history=r.history,
                health=r.health | _verdict.nonfinite_word(fe),
                dt_used=float(st.dt[i]), guard_retries=0))
        return infos


def _member_mv(ops, x):
    """``ops[m] @ x[m]`` for each member (the shell's dense products): one
    matrix-vector product a member, the product `System` takes, so a
    member's shell rows carry its solo run's bits. A batched GEMM would
    sum in another order, and the f32 shell preconditioner turns that
    into different GMRES iterations even in "full"."""
    return torch.stack([op @ v for op, v in zip(ops, x)])


def _lane_caches(c, B, i):
    """Member ``i``'s rows of folded fiber caches."""
    def rows(t):
        if t is None:
            return None
        return t.reshape((B, -1) + tuple(t.shape[1:]))[i]

    return type(c)(*[rows(t) for t in c])
