"""Offline precompute: periphery/body quadrature + dense shell operator inverse.

Counterpart of `skellysim_tpu.periphery.precompute` (the reference
SkellySim's `precompute.py:37-245`): build surface nodes (`shapes`),
triangulate (convex hull), compute Reeger-Fornberg quadrature weights
(`quadrature`), assemble the dense second-kind shell operator and invert
it. Results are plain dicts of numpy arrays with the JAX package's npz keys,
so precompute files written by either package load in the other.
"""

from __future__ import annotations

import time

import torch
from scipy.spatial import ConvexHull

from ..device import resolve_device
from .periphery import (build_shell_operator, build_shell_operator_device,
                        inverse_residual)
from .quadrature import surface_quadrature_weights
from .shapes import (ShapeSpec, ellipsoid_shape, sphere_shape,
                     surface_of_revolution_shape)

#: node radius inflation relative to the attachment radius
PERIPHERY_NODE_SCALE_FACTOR = 1.04
#: body quadrature radius shrinkage
BODY_QUADRATURE_RADIUS_OFFSET_LOW = 0.1
BODY_QUADRATURE_RADIUS_OFFSET_HIGH = 0.2
BODY_QUADRATURE_RADIUS_THRESHOLD = 2.0


def _shape_for_periphery(shape: str, n_nodes: int, **kw) -> ShapeSpec:
    s = PERIPHERY_NODE_SCALE_FACTOR
    if shape == "sphere":
        return sphere_shape(n_nodes, radius=kw["radius"] * s)
    if shape == "ellipsoid":
        return ellipsoid_shape(n_nodes, a=kw["a"] * s, b=kw["b"] * s,
                               c=kw["c"] * s)
    if shape == "surface_of_revolution":
        return surface_of_revolution_shape(kw["envelope"], scale_factor=s)
    raise ValueError(f"unknown periphery shape: {shape}")


def precompute_periphery(shape: str, n_nodes: int = 0, eta: float = 1.0,
                         device=None, stats: dict | None = None,
                         **kw) -> dict:
    """Full periphery precompute with the reference npz keys: nodes,
    normals (inward), quadrature_weights, stresslet_plus_complementary,
    M_inv (+ the envelope fit state for surfaces of revolution).

    The operator is assembled in float64 and inverted on ``device``: the
    card by default (`periphery.build_shell_operator_device`, M_inv stored
    in float32), or the host CPU when asked for (``device="cpu"``: the
    float64 scipy path of the JAX package's default precompute, whose npz
    it matches). Quadrature runs on the host either way. ``stats``, when
    given, receives the seconds of quadrature, assembly and inverse and
    ``inverse_residual``, max ||M M_inv e_j - e_j|| over 8 columns.
    """
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    spec = _shape_for_periphery(shape, n_nodes, **kw)
    nodes = spec.nodes
    normals = -spec.node_normals  # periphery normals point inward
    tris = ConvexHull(nodes).simplices
    weights = surface_quadrature_weights(nodes, tris, spec.gradh)
    stats["quadrature_s"] = time.perf_counter() - t0

    if dev.type == "cpu":
        operator, M_inv = build_shell_operator(nodes, normals, weights,
                                               eta=eta, timings=stats)
        stats["inverse_residual"] = inverse_residual(
            torch.as_tensor(operator), torch.as_tensor(M_inv))
    else:
        M, M_inv = build_shell_operator_device(nodes, normals, weights,
                                               eta=eta, device=dev,
                                               timings=stats)
        stats["inverse_residual"] = inverse_residual(M, M_inv)
        operator, M_inv = M.cpu().numpy(), M_inv.cpu().numpy()
        del M

    out = {
        "nodes": nodes,
        "normals": normals,
        "quadrature_weights": weights,
        "stresslet_plus_complementary": operator,
        "M_inv": M_inv,
    }
    if spec.envelope is not None:
        out.update(spec.envelope.get_state())
    return out


def precompute_body(shape: str, n_nodes: int, radius: float = 0.0,
                    a: float = 0.0, b: float = 0.0, c: float = 0.0) -> dict:
    """Body surface precompute: reference-frame nodes/normals + quadrature
    weights. Spheres shrink the quadrature-node radius below the
    hydrodynamic radius."""
    if shape == "sphere":
        r = radius - (BODY_QUADRATURE_RADIUS_OFFSET_LOW
                      if radius < BODY_QUADRATURE_RADIUS_THRESHOLD
                      else BODY_QUADRATURE_RADIUS_OFFSET_HIGH)
        spec = sphere_shape(n_nodes, radius=r)
    elif shape == "ellipsoid":
        spec = ellipsoid_shape(n_nodes, a=a, b=b, c=c)
    else:
        raise ValueError(f"unknown body shape: {shape}")

    tris = ConvexHull(spec.nodes).simplices
    weights = surface_quadrature_weights(spec.nodes, tris, spec.gradh)
    return {
        "node_positions_ref": spec.nodes,
        "node_normals_ref": spec.node_normals,
        "node_weights": weights,
    }
