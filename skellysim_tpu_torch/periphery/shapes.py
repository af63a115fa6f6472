"""Surface node/normal generation: sphere, ellipsoid, surface of revolution.

The port's own copy of `skellysim_tpu.periphery.shapes` (numpy only, the
same arithmetic, so nodes and normals equal the JAX package's bit for bit;
importing that module would import JAX). Mirror of the reference SkellySim
`ShapeGallery` (`src/skelly_sim/shape_gallery.py:59-214`):
spherical-Fibonacci node placement on spheres/ellipsoids,
arclength-equispaced rings for surfaces of revolution, with the implicit level function h and its
gradient for exact normals (consumed by the quadrature and collision checks).

The surface-of-revolution envelope takes the user's height expression (a string
over ``x`` with numpy available as ``np``, matching the reference's TOML
contract) and fits a Chebyshev proxy for fast evaluation/differentiation,
replacing the reference's `function_generator` dependency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class ShapeSpec:
    nodes: np.ndarray          # [N, 3]
    node_normals: np.ndarray   # [N, 3] outward unit normals
    h: Callable                # level function, h(points [N,3]) -> [N]
    gradh: Callable            # gradient, gradh(points) -> [N, 3]
    envelope: Optional["Envelope"] = None


def _fibonacci_sphere(n_nodes: int) -> np.ndarray:
    """Spherical-Fibonacci unit-sphere points (`shape_gallery.py:69-84`)."""
    phi = (1 + np.sqrt(5)) / 2
    N = n_nodes // 2
    i = np.arange(-N, N)
    lat = np.arcsin(2.0 * i / (2 * N + 1))
    lon = (i % phi) * 2 * np.pi / phi
    lon = np.where(lon < -np.pi, 2 * np.pi + lon, lon)
    lon = np.where(lon > np.pi, lon - 2 * np.pi, lon)
    return np.stack([np.cos(lon) * np.cos(lat),
                     np.sin(lon) * np.cos(lat),
                     np.sin(lat)], axis=1)


def sphere_shape(n_nodes: int, radius: float) -> ShapeSpec:
    nodes = radius * _fibonacci_sphere(n_nodes)

    def h(p):
        return np.sum(p * p, axis=1) - radius * radius

    def gradh(p):
        return 2.0 * p

    normals = gradh(nodes)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return ShapeSpec(nodes=nodes, node_normals=normals, h=h, gradh=gradh)


def ellipsoid_shape(n_nodes: int, a: float, b: float, c: float) -> ShapeSpec:
    abc = np.array([a, b, c])
    nodes = _fibonacci_sphere(n_nodes) * abc[None, :]

    def h(p):
        return np.sum((p / abc) ** 2, axis=1) - 1.0

    def gradh(p):
        return 2.0 * p / abc**2

    normals = gradh(nodes)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return ShapeSpec(nodes=nodes, node_normals=normals, h=h, gradh=gradh)


class Envelope:
    """Height function r(x) of a surface of revolution about the x axis.

    Accepts the reference's config contract (`shape_gallery.py:6-42`):
    ``height`` is a python expression in ``x``, with ``lower_bound``,
    ``upper_bound`` and any extra constants available as names in the
    expression. Internally fits a high-degree Chebyshev approximation for
    differentiation and fast evaluation.
    """

    def __init__(self, config: dict):
        self.config = dict(config)
        self.lower_bound = float(config["lower_bound"])
        self.upper_bound = float(config["upper_bound"])
        env = {k: v for k, v in config.items() if isinstance(v, (int, float))}
        env["np"] = np
        self.raw_height = eval("lambda x: " + config["height"], env)  # noqa: S307

        # fit slightly inside the bounds to dodge end-point singularities
        # (the reference's FunctionGenerator fit retries with shrunken bounds)
        delta = 1e-10 * (self.upper_bound - self.lower_bound)
        lo, hi = self.lower_bound + delta, self.upper_bound - delta
        x = 0.5 * (lo + hi) + 0.5 * (hi - lo) * np.cos(np.pi * np.arange(2000) / 1999)
        self._cheb = np.polynomial.Chebyshev.fit(x, self.raw_height(x), deg=200,
                                                 domain=[lo, hi])
        self._dcheb = self._cheb.deriv()

    def __call__(self, x):
        return self._cheb(np.clip(x, self.lower_bound, self.upper_bound))

    def differentiate(self, x):
        return self._dcheb(np.clip(x, self.lower_bound, self.upper_bound))

    def get_state(self) -> dict:
        """Serializable fit state (coefficient vector + bounds) for npz files."""
        return {
            "env_coef": self._cheb.coef,
            "env_domain": np.array(self._cheb.domain),
            "env_bounds": np.array([self.lower_bound, self.upper_bound]),
        }


def surface_of_revolution_shape(envelope_config: dict, scale_factor: float = 1.0) -> ShapeSpec:
    """Arclength-equispaced rings around the x axis (`shape_gallery.py:151-214`)."""
    env = Envelope(envelope_config)
    target_nodes = int(envelope_config["n_nodes_target"])
    n_x = int(round(np.sqrt(target_nodes)))

    # equi-arclength sampling of the generating curve
    x_fine = np.linspace(env.lower_bound, env.upper_bound, 1_000_000)
    r_fine = env.raw_height(x_fine)
    seg = np.sqrt(np.diff(x_fine) ** 2 + np.diff(r_fine) ** 2)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0, s[-1], n_x)
    xn = np.interp(t, s, x_fine)
    rn = env.raw_height(xn)

    ds = np.mean(np.sqrt(np.diff(xn) ** 2 + np.diff(rn) ** 2))
    nodes = []
    for xi, ri in zip(xn, rn):
        n_rad = int(round(2 * np.pi * ri / ds))
        if n_rad <= 1:
            nodes.append([xi, 0.0, 0.0])
            continue
        theta = 2 * np.pi * np.arange(n_rad) / n_rad
        for th in theta:
            nodes.append([xi, ri * np.cos(th), ri * np.sin(th)])
    nodes = np.asarray(nodes) * scale_factor

    def h(p):
        return env.raw_height(p[:, 0]) ** 2 - p[:, 1] ** 2 - p[:, 2] ** 2

    def gradh(p):
        out = np.zeros_like(p)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        hv = env(x)
        dh = env.differentiate(x)
        out[:, 0] = -hv * dh
        out[:, 1] = y
        out[:, 2] = z
        nrm = np.linalg.norm(out, axis=1, keepdims=True)
        out /= np.where(nrm > 0, nrm, 1.0)
        # end caps point along the axis
        out[x <= env.lower_bound] = [-1.0, 0.0, 0.0]
        out[x >= env.upper_bound] = [1.0, 0.0, 0.0]
        return out

    normals = gradh(nodes)
    return ShapeSpec(nodes=nodes, node_normals=normals, h=h, gradh=gradh, envelope=env)
