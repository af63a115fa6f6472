"""Config -> runnable simulation.

Counterpart of `skellysim_tpu.builder`: reads the TOML config and the
precompute npz files (written by either package's precompute) and assembles
`System`, the initial `SimState` and the `SimRNG` on the requested device
(the card unless ``device="cpu"``). With ``synthesize_body_precompute``
(the service's tenants, whose TOML arrives over the wire without npz
files) a sphere or ellipsoid body whose npz is missing gets its quadrature
rebuilt in-process and placed on the scene's device. Deformable bodies
are refused, as in the reference.
"""

from __future__ import annotations

import functools
import os
import struct
import warnings
import zipfile

import numpy as np
import torch

from .bodies import bodies as bd
from .config import schema
from .device import resolve_device
from .fibers import container as fc
from .params import resolve_precision
from .periphery import periphery as peri
from .system import BackgroundFlow, PointSources, System
from .system.buckets import pad_for_mesh
from .utils import quaternion as quat
from .utils.rng import SimRNG


def _load_npz(path: str, what: str, mapped: bool = False) -> dict:
    """Every array of a precompute npz. ``mapped``: members stored
    uncompressed (both packages' precompute write them so) come back as
    copy-on-write memory maps of the file instead of being read, so a
    caller that copies them straight to the card reads each byte once (the
    8,000-node shell's npz is 6.9 GB)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} precompute file '{path}' not found — run the precompute "
            "step first (python -m skellysim_tpu_torch.precompute)")
    if mapped:
        with zipfile.ZipFile(path) as zf:
            members = zf.infolist()
        out = {}
        for info in members:
            arr = _mapped_member(path, info)
            if arr is None:
                break
            out[info.filename[:-len(".npy")]] = arr
        else:
            return out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mapped_member(path: str, info: zipfile.ZipInfo):
    """A copy-on-write `np.memmap` of one uncompressed ``.npy`` member of
    an npz, or None for any other member."""
    if (info.compress_type != zipfile.ZIP_STORED
            or not info.filename.endswith(".npy")):
        return None
    fmt = np.lib.format
    with open(path, "rb") as fh:
        fh.seek(info.header_offset)
        local = fh.read(30)
        if local[:4] != b"PK\x03\x04":
            return None
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        fh.seek(info.header_offset + 30 + n_name + n_extra)
        version = fmt.read_magic(fh)
        read_header = {(1, 0): fmt.read_array_header_1_0,
                       (2, 0): fmt.read_array_header_2_0}.get(version)
        if read_header is None:
            return None
        shape, fortran, dtype = read_header(fh)
        offset = fh.tell()
    if dtype.hasobject:
        return None
    if not shape:
        return np.fromfile(path, dtype=dtype, count=1,
                           offset=offset).reshape(())
    if 0 in shape:
        return np.zeros(shape, dtype=dtype)
    return np.memmap(path, dtype=dtype, mode="c", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def build_fibers(cfg_fibers: list, dtype, device):
    """FiberGroup (one resolution) or tuple of per-resolution buckets in
    first-appearance order; each fiber's config position is its
    `config_rank` (trajectory wire order)."""
    if not cfg_fibers:
        return None
    by_n: dict = {}
    for rank, f in enumerate(cfg_fibers):
        by_n.setdefault(int(f.n_nodes), []).append((rank, f))

    def one_bucket(items):
        ranks = [r for r, _ in items]
        fibs = [f for _, f in items]
        n = fibs[0].n_nodes
        x = np.stack([np.asarray(f.x, dtype=float).reshape(n, 3) for f in fibs])
        return fc.make_group(
            x,
            lengths=np.array([f.length for f in fibs]),
            bending_rigidity=np.array([f.bending_rigidity for f in fibs]),
            radius=np.array([f.radius for f in fibs]),
            force_scale=np.array([f.force_scale for f in fibs]),
            minus_clamped=np.array([f.minus_clamped or f.parent_body >= 0
                                    for f in fibs]),
            binding_body=np.array([f.parent_body for f in fibs], dtype=np.int32),
            binding_site=np.array([f.parent_site for f in fibs], dtype=np.int32),
            config_rank=np.array(ranks, dtype=np.int32),
            dtype=dtype, device=device)

    groups = [one_bucket(items) for items in by_n.values()]
    return groups[0] if len(groups) == 1 else tuple(groups)


@functools.lru_cache(maxsize=16)
def _analytic_body(shape: str, n_nodes: int, radius: float, a: float,
                   b: float, c: float) -> dict:
    """A sphere's or ellipsoid's surface precompute, kept for the process:
    a deterministic function of its arguments that a server would
    otherwise rebuild for every tenant (~0.8 s at 400 nodes)."""
    from .periphery.precompute import precompute_body

    return precompute_body(shape, n_nodes, radius=radius, a=a, b=b, c=c)


def build_bodies(cfg_bodies: list, config_dir: str, dtype, device,
                 synthesize_precompute: bool = False):
    """BodyGroup (one shape/resolution) or tuple of per-(shape, n_nodes,
    n_sites) buckets in first-appearance order; each body's config position
    is its `config_rank` (the GLOBAL id fibers' `parent_body` refers to).

    ``synthesize_precompute`` computes an analytic (sphere / ellipsoid)
    body's surface in-process when its npz is missing (the service's
    path: a tenant's quadrature is a deterministic function of shape,
    n_nodes and radius); off, a missing file raises as in the CLIs."""
    if not cfg_bodies:
        return None
    if any(b.shape == "deformable" for b in cfg_bodies):
        from .bodies import deformable

        deformable.make_group()  # raises: the reference's unimplemented stub
    def load(b):
        path = os.path.join(config_dir, b.precompute_file)
        if (synthesize_precompute and not os.path.exists(path)
                and b.shape in ("sphere", "ellipsoid")):
            pre = _analytic_body(b.shape, b.n_nodes, float(b.radius),
                                 *map(float, b.axis_length))
            return {k: v.copy() for k, v in pre.items()}
        return _load_npz(path, "body")

    pre_all = [load(b) for b in cfg_bodies]

    def runtime_quat(b):
        # TOML orientation is [x, y, z, w]; the runtime and the trajectory
        # wire use (w, x, y, z)
        x, y, z, w = np.asarray(b.orientation, dtype=float)
        return np.array([w, x, y, z])

    def sites_ref(b, ns):
        # config nucleation sites are lab-frame at t=0: ref = R(q)^T (lab -
        # pos), i.e. (lab - pos) @ R
        s = np.asarray(b.nucleation_sites, dtype=float).reshape(ns, 3)
        R = quat.rotation_matrix(torch.as_tensor(runtime_quat(b))).numpy()
        return (s - np.asarray(b.position)) @ R

    by_key: dict = {}
    for rank, (b, p) in enumerate(zip(cfg_bodies, pre_all)):
        key = (b.shape, p["node_positions_ref"].shape[0],
               len(b.nucleation_sites) // 3)
        by_key.setdefault(key, []).append((rank, b, p))

    def one_bucket(key, items):
        shape, _, ns = key
        bods = [b for _, b, _ in items]
        pre = [p for _, _, p in items]
        return bd.make_group(
            np.stack([p["node_positions_ref"] for p in pre]),
            np.stack([p["node_normals_ref"] for p in pre]),
            np.stack([p["node_weights"] for p in pre]),
            position=np.stack([b.position for b in bods]),
            orientation=np.stack([runtime_quat(b) for b in bods]),
            nucleation_sites_ref=np.stack([sites_ref(b, ns) for b in bods]),
            external_force=np.stack([b.external_force for b in bods]),
            external_torque=np.stack([b.external_torque for b in bods]),
            ext_force_type=np.array(
                [bd.EXTFORCE_OSCILLATORY
                 if b.external_force_type == "Oscillatory"
                 else bd.EXTFORCE_LINEAR for b in bods], dtype=np.int32),
            osc_amplitude=np.array([b.external_oscillation_force_amplitude
                                    for b in bods]),
            osc_omega=np.array([2 * np.pi
                                * b.external_oscillation_force_frequency
                                for b in bods]),
            osc_phase=np.array([b.external_oscillation_force_phase
                                for b in bods]),
            radius=np.array([b.radius for b in bods]),
            kind=shape if shape in ("sphere", "ellipsoid") else "generic",
            semiaxes=np.array([b.axis_length if b.shape == "ellipsoid"
                               else [0.0, 0.0, 0.0] for b in bods]),
            config_rank=np.array([r for r, _, _ in items], dtype=np.int32),
            dtype=dtype, device=device)

    groups = [one_bucket(key, items) for key, items in by_key.items()]
    return groups[0] if len(groups) == 1 else tuple(groups)


def build_periphery(cfg_periphery, config_dir: str, dtype, device,
                    precond_dtype=None):
    """(PeripheryState, PeripheryShape) from the config and its npz;
    ``precond_dtype`` stores M_inv (the preconditioner) in a lower
    precision (float32 in mixed mode)."""
    # on the card the dense operators go straight from the file's pages to
    # the device; a CPU state keeps arrays of its own
    data = _load_npz(os.path.join(config_dir, cfg_periphery.precompute_file),
                     "periphery",
                     mapped=resolve_device(device).type == "cuda")
    state = peri.make_state(data["nodes"], data["normals"],
                            data["quadrature_weights"],
                            data["stresslet_plus_complementary"],
                            data["M_inv"], dtype=dtype,
                            precond_dtype=precond_dtype, device=device)
    shape_name = getattr(cfg_periphery, "shape", "sphere")
    if shape_name == "sphere":
        shape = peri.PeripheryShape(kind="sphere", radius=cfg_periphery.radius)
    elif shape_name == "ellipsoid":
        shape = peri.PeripheryShape(
            kind="ellipsoid",
            abc=(cfg_periphery.a, cfg_periphery.b, cfg_periphery.c))
    else:
        shape = peri.PeripheryShape(kind="generic")
    return state, shape


def build_point_sources(cfg_points: list, dtype, device):
    if not cfg_points:
        return None
    return PointSources.make(
        position=np.stack([p.position for p in cfg_points]),
        force=np.stack([p.force for p in cfg_points]),
        torque=np.stack([p.torque for p in cfg_points]),
        time_to_live=np.array([p.time_to_live for p in cfg_points]),
        dtype=dtype, device=device)


def build_background(cfg_bg, dtype, device):
    if cfg_bg is None:
        return None
    if not any(cfg_bg.uniform) and not any(cfg_bg.scale_factor):
        return None
    return BackgroundFlow.make(uniform=cfg_bg.uniform,
                               components=cfg_bg.components,
                               scale=cfg_bg.scale_factor, dtype=dtype,
                               device=device)


def build_simulation(config, config_dir: str = ".", dtype=torch.float64,
                     device=None, mesh=None,
                     synthesize_body_precompute: bool = False):
    """Config (object or TOML path) -> (System, SimState, SimRNG); the
    precompute npz files are read from ``config_dir`` (a TOML path's own
    directory).

    ``mesh`` (`parallel.make_mesh`) enables the ring pair evaluator when
    the config selects pair_evaluator = "ring": each fiber bucket is then
    padded with inert fibers to a mesh-divisible node count
    (`system.buckets.pad_for_mesh`). Without a mesh the direct evaluator
    runs (the CLI builds none). ``synthesize_body_precompute``: see
    `build_bodies`."""
    if isinstance(config, (str, os.PathLike)):
        config_dir = os.path.dirname(os.path.abspath(config)) or "."
        config = schema.load_config(str(config))
    device = resolve_device(device)
    params = schema.to_runtime_params(config.params)
    if params.pair_evaluator == "ring" and mesh is None:
        warnings.warn("config selects pair_evaluator='ring' but no mesh was "
                      "given to build_simulation; using the direct evaluator")
    shell, shape = None, None
    if getattr(config, "periphery", None) is not None:
        mixed = resolve_precision(params.solver_precision,
                                  dtype == torch.float64,
                                  device.type) == "mixed"
        shell, shape = build_periphery(
            config.periphery, config_dir, dtype, device,
            precond_dtype=torch.float32 if mixed else None)
    fibers = build_fibers(config.fibers, dtype, device)
    if params.pair_evaluator == "ring" and mesh is not None:
        fibers = pad_for_mesh(fibers, mesh.size)
    system = System(params, shell_shape=shape, device=device, mesh=mesh)
    state = system.make_state(
        fibers=fibers,
        points=build_point_sources(config.point_sources, dtype, device),
        background=build_background(config.background, dtype, device),
        shell=shell,
        bodies=build_bodies(config.bodies, config_dir, dtype, device,
                            synthesize_precompute=synthesize_body_precompute))
    return system, state, SimRNG(seed=config.params.seed)
