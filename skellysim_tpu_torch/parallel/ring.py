"""Ring-pass pairwise Stokes sums over a device mesh.

Counterpart of `skellysim_tpu.parallel.ring`: each shard keeps its target
block resident and the source blocks rotate neighbour to neighbour, so a
shard never holds more than one foreign source block at a time. The
accumulation order is the JAX ring's, shard by shard: the own block first,
then the left neighbour's, and so on.

Two transports serve one call site (`_ring_or_fused`):

* the fused ring kernels E / F (`ops.cuda_kernels.ring_stokeslet_f32` /
  `ring_stresslet_f32`, the counterparts of the JAX package's
  `ring_fused.fused_ring_block_sum`): the f32 ``impl="pallas"`` interior on
  CUDA tensors, one launch a card, the blocks moving inside the kernel.
  JAX's VMEM budget gate (`fused_ring_fits`) does not carry over: the
  card's ring slots live in device memory and serve every shape, so shapes
  a TPU sends back to the ``ppermute`` ring take the fused kernel here;
* the hop-by-hop accumulation `_ring_accumulate` (the JAX package's
  ``lax.ppermute`` loop): hop j moves every shard's rotating blocks to the
  next shard's device (``perm = [(j, j + 1 mod n)]``), and each shard adds
  one block sum a hop. It serves ``impl="exact"`` (kernels A / B or C / D a
  hop, by the operands' precision; their plain versions on the CPU),
  ``impl="mxu"`` (the matmul-form tile a hop, plain torch as in the JAX
  package), the opt-out ``SKELLY_FUSED_RING=0``, every CPU tensor, and the
  f64-grade ``ring_*_df`` sums (kernel B or D a hop under "pallas_df", the
  double-float tile under "df"; the f64 sum kept).

Inputs are whole [N, ...] tensors on the caller's device whose leading axis
the mesh size divides (pad first, as `System` does); they are cut into
equal shard blocks, each placed on its shard's device, and the result comes
back to the caller's device. `ring_flow_local` is the sharded step's
in-mesh seam instead (`parallel.spmd`): its operands are already one block
a shard, and its result stays so.

On a mesh that spans processes (`parallel.multihost`) every per-shard list
holds this process's shards only. A whole-tensor call takes the same
whole inputs in every process, keeps its own blocks and all-gathers the
result. A hop whose next shard lies in another process sends its blocks
there by `torch.distributed` (`multihost.exchange`), posted before the
hop's block sums as the local moves are; the fused kernels ring across
processes through CUDA IPC mappings of each shard's slots and counters
(`ops.cuda_kernels`), where `compat.fused_ring_mode`'s layout rule allows.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..obs import cost as _cost
from ..obs.profile import phase
from ..ops import cuda_kernels
from ..ops import kernels
from ..ops.kernels import DEFAULT_EPS, DEFAULT_REG, pallas_impl_for
from .compat import fused_ring_mode
from .mesh import Mesh

#: payload columns a source, by kernel family
_PAYLOAD_COLS = {"stokeslet": 3, "stresslet": 9}


def _shard(a, mesh: Mesh) -> list:
    """[N, ...] -> this process's of ``mesh.size`` equal leading blocks,
    block k on shard k's device (views when the shard lives on ``a``'s
    device)."""
    n = mesh.size
    if a.shape[0] % n != 0:
        raise ValueError(f"ring operands need a leading axis divisible by the "
                         f"mesh size ({n}); got {tuple(a.shape)}")
    m = a.shape[0] // n
    return [a[k * m:(k + 1) * m].to(mesh.devices[k]) for k in mesh.local]


def _gather(blocks, device, mesh: Mesh) -> torch.Tensor:
    """This process's blocks, and every other process's where the mesh
    spans processes, concatenated in shard order on ``device``."""
    out = torch.cat([b.to(device) for b in blocks], dim=0)
    if mesh.spans_processes:
        from . import multihost

        out = torch.cat(multihost.all_gather(out), dim=0)
    return out


def _ring_accumulate(block_fn, devices, u0, *rotating, mesh=None) -> list:
    """Accumulate ``block_fn(k, *blocks)`` into shard k's ``u0[k]`` over all
    ring positions. ``rotating`` are per-shard lists; at hop j shard k holds
    the blocks of shard (k - j) mod n. Each hop issues the move of the NEXT
    blocks before the block sums of the current ones (the JAX ring's
    overlap: the two are independent), and the final position is consumed
    without a trailing move: n - 1 hops. ``devices`` are the listed
    shards' devices; on a ``mesh`` that spans processes they are this
    process's shards (``mesh.local``), and the first of them receives from
    the process on its left while the last sends to the one on its
    right. On more than one shard each hop is the phase ``ring-step``
    (`obs.profile.phase`), as each ``ppermute`` hop is in the JAX
    package."""
    n_loc = len(devices)
    spans = mesh is not None and mesh.spans_processes
    n = mesh.size if spans else n_loc
    u = list(u0)
    rot = [list(r) for r in rotating]
    for hop in range(n):
        with phase("ring-step") if n > 1 else contextlib.nullcontext():
            nxt = wait = None
            if hop < n - 1:
                if spans:
                    nxt, wait = _post_hop(mesh, devices, rot)
                else:
                    nxt = [[r[(k - 1) % n].to(devices[k], non_blocking=True)
                            for k in range(n)] for r in rot]
            u = [u[k] + block_fn(k, *(r[k] for r in rot))
                 for k in range(n_loc)]
            if wait is not None:
                for r, got in zip(nxt, wait()):
                    r[0] = got
            if nxt is not None:
                rot = nxt
    return u


def _post_hop(mesh: Mesh, devices, rot):
    """One hop's moves on a mesh that spans processes: within the process
    as `_ring_accumulate` moves them; the last local shard's blocks sent
    to the process of the next shard, the first local shard's received
    from the process of the one before (its slot left None until the
    returned ``wait`` fills it)."""
    from . import multihost

    local = mesh.local
    n, n_loc = mesh.size, len(devices)
    nxt = [[None] + [r[k - 1].to(devices[k], non_blocking=True)
                     for k in range(1, n_loc)] for r in rot]
    wait = multihost.exchange(
        [r[-1] for r in rot], mesh.owner((local[-1] + 1) % n),
        [r[0] for r in rot], mesh.owner((local[0] - 1) % n))
    return nxt, wait


def _ring_or_fused(kind, impl: str, block_fn, mesh: Mesh, r_trg, *rotating,
                   acc_dtype=None):
    """THE ring call site: the fused ring kernel where `compat
    .fused_ring_mode` selects it on a mesh of more than one shard, else the
    hop-by-hop accumulation of ``block_fn(trg, *blocks)`` (unscaled) from
    zero, in ``acc_dtype`` (default: the targets'). ``r_trg`` and
    ``rotating`` are per-shard lists; returns the unscaled per-shard sums.
    ``kind`` names the fused family ("stokeslet" / "stresslet"; None for
    tiles it does not serve). Under `obs.cost` the fused kernel's wrapper
    and each hop's block are the pair seams."""
    if (kind is not None and mesh.size > 1
            and fused_ring_mode(impl, r_trg[0].device, mesh) == "fused"):
        return getattr(cuda_kernels, f"ring_{kind}_f32")(
            r_trg, *rotating, mesh=mesh if mesh.spans_processes else None)
    return _ring_accumulate(
        lambda k, *blk: block_fn(r_trg[k], *blk), mesh.local_devices,
        [torch.zeros((t.shape[0], 3), dtype=acc_dtype or t.dtype,
                     device=t.device) for t in r_trg], *rotating, mesh=mesh)


def _ring_block(impl: str, family: str, dtype):
    """Per-hop block of the hop-by-hop ring: the unscaled pair sum of the
    operands' precision (kernel A / C in f32, B / D in f64; their plain
    versions on the CPU), as `ops.kernels` routes "exact" and "pallas".
    Names the ring does not serve raise."""
    if impl in ("exact", "pallas"):
        prec = "f32" if dtype == torch.float32 else "f64"
        kern = getattr(cuda_kernels, f"{family}_{prec}")
        return lambda trg, src, pay: kern(src, trg, pay)
    if impl == "mxu":
        # the matmul-form tile over the whole rotating block, recentered on
        # its first point as the JAX package's ring tile is
        return _cost.seamed(family, _cost.block_work)(
            lambda trg, src, pay: kernels.mxu_sum(
                family, src, trg, _unflat(family, pay),
                centered_chunk=src.shape[0]))
    raise ValueError(
        f"ring evaluator has no {impl!r} tile; use 'exact', 'mxu' or "
        "'pallas' (double-float rides ring_stokeslet_df / "
        "ring_stresslet_df)")


def _unflat(family: str, pay):
    """A ring payload block in its family's shape (the stresslet's
    [n, 3, 3] from the ring's flat [n, 9])."""
    return pay.reshape(-1, 3, 3) if family == "stresslet" else pay


def _ring_eval(kind: str, impl: str, mesh: Mesh, scale, r_trg, src, payload):
    """Shard, run the ring, scale, and bring the result back to
    ``r_trg``'s device."""
    block = _ring_block(impl, kind, r_trg.dtype)
    payload = payload.reshape(payload.shape[0], _PAYLOAD_COLS[kind])
    u = _ring_or_fused(kind, impl, block, mesh, _shard(r_trg, mesh),
                       _shard(src, mesh), _shard(payload, mesh))
    return _gather([x * scale for x in u], r_trg.device, mesh)


def ring_stokeslet(r_src, r_trg, f_src, eta, *, mesh: Mesh,
                   impl: str = "exact"):
    """Ring-parallel singular Stokeslet sum (`ops.kernels
    .stokeslet_direct`); the leading axes of ``r_src`` / ``f_src`` /
    ``r_trg`` must be divisible by the mesh size. ``impl="pallas"`` with
    f32 operands on the card takes kernel E; f64 operands resolve it to
    "exact", as the direct seam does."""
    impl = pallas_impl_for(impl, r_trg, r_src, f_src)
    return _ring_eval("stokeslet", impl, mesh, 1.0 / (8.0 * math.pi * eta),
                      r_trg, r_src, f_src)


def ring_stresslet(r_dl, r_trg, f_dl, eta, *, mesh: Mesh,
                   impl: str = "exact"):
    """Ring-parallel stresslet (double-layer) sum (`ops.kernels
    .stresslet_direct`); ``f_dl`` is [n_src, 3, 3]. ``impl="pallas"`` with
    f32 operands on the card takes kernel F."""
    impl = pallas_impl_for(impl, r_trg, r_dl, f_dl)
    return _ring_eval("stresslet", impl, mesh, 1.0 / (8.0 * math.pi * eta),
                      r_trg, r_dl, f_dl)


def _df_ring_block(impl: str, family: str):
    """f64-grade per-hop block, unscaled, f32 or f64 in, f64 out:
    "pallas_df" is one launch of kernel B / D (the plain f64 version on the
    CPU); "df" the JAX package's double-float tile (`ops.df_kernels`, plain
    torch on every device)."""
    if impl == "pallas_df":
        kern = getattr(cuda_kernels, f"{family}_f64")
        return lambda trg, src, pay: kern(src, trg, pay)
    if impl == "df":
        from ..ops import df_kernels

        block = getattr(df_kernels, f"{family}_block_df")
        return _cost.seamed(family, _cost.block_work)(
            lambda trg, src, pay: df_kernels.df_block_sum(
                block, src, trg, _unflat(family, pay)))
    raise ValueError(f"DF ring tiles serve 'df' or 'pallas_df', got {impl!r}")


def _ring_df(family: str, impl: str, mesh: Mesh, r_src, r_trg, payload, eta):
    """The f64-grade ring: each shard keeps an f64 sum of its resident
    targets over the rotating blocks; returns float64 targets."""
    block = _df_ring_block(impl, family)
    trg = _shard(r_trg, mesh)
    payload = payload.reshape(payload.shape[0], _PAYLOAD_COLS[family])
    u0 = [torch.zeros((t.shape[0], 3), dtype=torch.float64, device=t.device)
          for t in trg]
    u = _ring_accumulate(lambda k, s, p: block(trg[k], s, p),
                         mesh.local_devices, u0, _shard(r_src, mesh),
                         _shard(payload, mesh), mesh=mesh)
    return _gather([x / (8.0 * math.pi) / float(eta) for x in u],
                   r_trg.device, mesh)


def ring_stokeslet_df(r_src, r_trg, f_src, eta, *, mesh: Mesh,
                      impl: str = "pallas_df"):
    """Ring-parallel f64-grade Stokeslet sum: float64 targets, one kernel B
    launch a hop and shard (``impl="pallas_df"``), or the double-float
    tile a hop (``impl="df"``, the JAX package's default)."""
    return _ring_df("stokeslet", impl, mesh, r_src, r_trg, f_src, eta)


def ring_stresslet_df(r_dl, r_trg, f_dl, eta, *, mesh: Mesh,
                      impl: str = "pallas_df"):
    """Ring-parallel f64-grade stresslet; ``f_dl`` is [n_src, 3, 3]; one
    kernel D launch a hop and shard, or the double-float tile
    (``impl="df"``)."""
    return _ring_df("stresslet", impl, mesh, r_dl, r_trg, f_dl, eta)


def ring_flow_local(kind: str, impl: str, r_trg, src, payload, eta, *, comm,
                    ring: bool = True):
    """Pairwise flow for the sharded step (`skellysim_tpu.parallel.ring
    .ring_flow_local`): the one place its evaluation contract lives for
    every tile, so the fiber and shell callers cannot drift apart.

    ``r_trg``, ``src`` and ``payload`` hold one block a shard (shard k's on
    its device); ``comm`` is the step's collective seam
    (`parallel.spmd.Collectives`). ``kind`` picks the kernel ("stokeslet":
    payload [n, 3] forces; "stresslet": [n, 3, 3]). ``ring=True`` sums
    every shard's sources at each shard's resident targets around the ring
    (`_ring_or_fused`: kernel E / F in one launch for f32 operands and
    ``impl="pallas"`` on the card, else A / C or B / D a hop). ``ring=False``
    sums each shard's own sources only: the partial of REPLICATED target
    rows, which the caller adds across shards in shard order
    (``comm.psum``), so that they come out the same bits on every shard (a
    ring would add the same terms in another order on each). The f64-grade
    tiles ("pallas_df": B / D) accumulate in float64 and cast back to the
    targets' dtype. Returns one [n_trg, 3] block a shard."""
    cols = _PAYLOAD_COLS[kind]
    payload = [p.reshape(p.shape[0], cols) for p in payload]
    if impl in ("df", "pallas_df"):
        block = _df_ring_block(impl, kind)
        scale = 1.0 / (8.0 * math.pi) / float(eta)
        if ring:
            u = comm.ring(None, impl, block, r_trg, src, payload,
                          acc_dtype=torch.float64)
        else:
            u = [block(t, s, p) for t, s, p in zip(r_trg, src, payload)]
        return [(x * scale).to(t.dtype) for x, t in zip(u, r_trg)]
    impl = pallas_impl_for(impl, r_trg[0], src[0], payload[0])
    block = _ring_block(impl, kind, r_trg[0].dtype)
    scale = 1.0 / (8.0 * math.pi * eta)
    if ring:
        u = comm.ring(kind, impl, block, r_trg, src, payload)
    else:
        u = [block(t, s, p) for t, s, p in zip(r_trg, src, payload)]
    return [x * scale for x in u]


def ring_oseen_contract(r_src, r_trg, density, eta, reg=DEFAULT_REG,
                        epsilon_distance=DEFAULT_EPS, *, mesh: Mesh):
    """Ring-parallel regularized Oseen contraction (`ops.kernels
    .oseen_contract`, already eta-scaled), hop by hop: the JAX package's
    Oseen tile is plain XLA, with no Pallas kernel to port, so each hop is
    the plain contraction on its shard's device. The leading axes must be
    divisible by the mesh size."""
    def block(trg, src, rho):
        return kernels.oseen_contract(src, trg, rho, eta, reg,
                                      epsilon_distance)

    u = _ring_or_fused(None, "exact", block, mesh, _shard(r_trg, mesh),
                       _shard(r_src, mesh), _shard(density, mesh))
    return _gather(u, r_trg.device, mesh)


# ---------------------------------------------------------------- the registry

def auditable_kernels():
    """This layer's entries in the kernel registry (`audit.kernels`): the
    fused ring kernels E (``ring_stokeslet_fused``) and F
    (``ring_stresslet_fused``), the JAX package's names, on a mesh of 4
    shards of one card at a ragged shape (1,237 targets and 509 sources a
    shard)."""
    from ..audit.registry import AuditKernel, BuiltKernel, KernelCase

    def build(family, letter):
        def _build(device=None):
            from ..device import resolve_device
            from .mesh import make_mesh

            dev = resolve_device(device)
            mesh = make_mesh(4, device=dev)
            cols = 3 if family == "stokeslet" else 9
            gen = torch.Generator().manual_seed(5)

            def cloud(n, c):
                return [torch.randn((n, c), generator=gen,
                                    dtype=torch.float32).to(d)
                        for d in mesh.devices]

            # one process: the lists alone (a mesh argument is for a ring
            # across processes)
            args = (cloud(1237, 3), cloud(509, 3), cloud(509, cols))
            name = f"ring_{family}_f32"
            tiles = "StokesletTiles" if family == "stokeslet" \
                else "StressletTiles"
            return BuiltKernel(
                source=cuda_kernels.RING_SOURCE, device=dev,
                cases=[KernelCase(
                    label=f"{letter} {name}",
                    wrapper=getattr(cuda_kernels, name),
                    plain=getattr(cuda_kernels, f"{name}_plain"), args=args,
                    rtol=1e-4, entries=(rf"ring_kernelINS_8TilePathINS_\d+"
                                        rf"{tiles}", r"ring_reduce_kernel"))])
        return _build

    return [
        AuditKernel(name="ring_stokeslet_fused", layer="parallel",
                    summary="fused Stokeslet ring E, csrc/ring_sums.cu",
                    kernels="E", build=build("stokeslet", "E")),
        AuditKernel(name="ring_stresslet_fused", layer="parallel",
                    summary="fused stresslet ring F, csrc/ring_sums.cu",
                    kernels="F", build=build("stresslet", "F")),
    ]
