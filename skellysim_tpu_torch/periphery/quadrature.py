"""High-order quadrature weights on smooth closed triangulated surfaces.

The port's own copy of `skellysim_tpu.periphery.quadrature` (numpy and
scipy only, the same arithmetic, so the weights equal the JAX package's to
round-off; importing that module would import JAX).

Implements the method of J. A. Reeger, B. Fornberg, and M. L. Watts,
"Numerical quadrature over smooth, closed surfaces" (Proc. R. Soc. A 472, 2016)
— the same algorithm behind the reference SkellySim's precompute quadrature
(`src/skelly_sim/Smooth_Closed_Surface_Quadrature_RBF.py`), but
re-implemented from the published method with the per-triangle work batched
into stacked linear solves instead of a Python loop per triangle.

Algorithm sketch (per triangle of the convex-hull triangulation):
 1. Build a projection point O from the triangle's three edge planes (each edge
   paired with the average normal of its two adjacent triangles); projecting
   nearby surface nodes onto the triangle's plane from O tiles the surface
   exactly (adjacent triangles share their edge planes).
 2. Map the k nearest surface nodes into 2-D plane coordinates.
 3. Integrate the polyharmonic RBF phi(r) = r^7 centered at each projected
   node exactly over the triangle (right-triangle decomposition), and all
   monomials x^a y^b of total degree <= m exactly (divergence-theorem polygon
   moments).
 4. Solve the RBF+poly saddle system for plane quadrature weights.
 5. Scale each weight by the surface/plane area-element distortion computed
   from the exact surface normal (gradh) and accumulate onto the nodes.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

POLY_ORDER = 7          # m in the paper
N_NEIGHBORS = 80        # k in the paper; >= (m+1)(m+2)/2 = 36
_CHUNK = 512            # triangles per batched solve


def _triangle_normals(nodes, tris):
    v1 = nodes[tris[:, 1]] - nodes[tris[:, 0]]
    v2 = nodes[tris[:, 2]] - nodes[tris[:, 0]]
    n = np.cross(v1, v2)
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def _edge_normals(nodes, tris, tri_normals):
    """For each triangle's three edges, the sign-aligned average of the normals
    of the two triangles sharing that edge. Returns [T, 3, 3] (edge order:
    (v0,v1), (v0,v2), (v1,v2) of the index-sorted triangle)."""
    T = len(tris)
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [0, 2]], tris[:, [1, 2]]])
    owner = np.concatenate([np.arange(T)] * 3)
    # canonical edge key
    key = edges[:, 0].astype(np.int64) * len(nodes) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    e_sorted, o_sorted = key[order], owner[order]
    assert np.all(e_sorted[0::2] == e_sorted[1::2]), "non-manifold triangulation"
    n_a = tri_normals[o_sorted[0::2]]
    n_b = tri_normals[o_sorted[1::2]]
    sign = np.sign(np.sum(n_a * n_b, axis=1, keepdims=True))
    avg = n_a + sign * n_b
    avg /= np.linalg.norm(avg, axis=1, keepdims=True)
    # scatter the average back to both owners
    edge_normal = np.empty((3 * T, 3))
    edge_normal[order[0::2]] = avg
    edge_normal[order[1::2]] = avg
    return edge_normal.reshape(3, T, 3).transpose(1, 0, 2)


def _projection_points(nodes, tris, edge_normals):
    """Intersection of the three edge planes: the point O from which the
    projection onto the triangle plane tiles the surface."""
    A = nodes[tris[:, 0]]
    B = nodes[tris[:, 1]]
    C = nodes[tris[:, 2]]
    nAB, nAC, nBC = edge_normals[:, 0], edge_normals[:, 1], edge_normals[:, 2]
    # plane through edge e with in-plane direction e and normal direction n_e:
    # its normal is n_e x e
    pAB = np.cross(nAB, B - A)
    pAC = np.cross(nAC, C - A)
    pBC = np.cross(nBC, C - B)
    v = np.cross(pAB, pAC)  # direction through A common to both planes
    denom = np.sum(pBC * v, axis=1)
    t = np.sum(pBC * (B - A), axis=1) / denom
    return A + t[:, None] * v


def _monomial_exponents(m):
    return np.array([(a - b, b) for a in range(m + 1) for b in range(a + 1)])


def _polygon_monomial_integrals(verts, m):
    """Exact integrals of x^a y^b (a+b <= m) over batched triangles.

    ``verts`` is [T, 3, 2]. Uses the divergence theorem:
    integral x^a y^b dA = 1/(a+1) * contour integral x^(a+1) y^b dy,
    with each (linearly parameterized) side integrated by Gauss-Legendre of
    sufficient order (exact for the polynomial integrand).
    """
    exps = _monomial_exponents(m)
    q, wq = np.polynomial.legendre.leggauss(m + 2)  # exact to degree 2m+3
    q = 0.5 * (q + 1.0)
    wq = 0.5 * wq

    T = verts.shape[0]
    out = np.zeros((T, len(exps)))
    for side in range(3):
        p0 = verts[:, side]
        p1 = verts[:, (side + 1) % 3]
        dx = p1 - p0
        # points along the side: [T, q, 2]
        pts = p0[:, None, :] + q[None, :, None] * dx[:, None, :]
        dy = dx[:, 1]
        for i, (a, b) in enumerate(exps):
            integrand = pts[:, :, 0] ** (a + 1) * pts[:, :, 1] ** b
            out[:, i] += (integrand @ wq) * dy / (a + 1)
    return out, exps


def _rbf_triangle_integrals(centers, verts):
    """Exact integral of phi(r) = r^7 centered at each point over each triangle.

    ``centers`` [T, k, 2], ``verts`` [T, 3, 2]; right-triangle decomposition:
    for each side, drop the orthogonal foot from the center, producing two
    signed right triangles with legs alpha (height) and beta (along the side);
    integral of r^7 over such a right triangle has the closed form
    alpha*(beta*sqrt(a^2+b^2)*(279a^6+326a^4b^2+200a^2b^4+48b^6)
           + 105 a^8 asinh(b/a)) / 3456.
    """
    Tn, k, _ = centers.shape
    out = np.zeros((Tn, k))
    sABC = np.sign(
        (verts[:, 0, 1] - verts[:, 1, 1]) * (verts[:, 2, 0] - verts[:, 0, 0])
        + (verts[:, 1, 0] - verts[:, 0, 0]) * (verts[:, 2, 1] - verts[:, 0, 1]))

    def right_tri(alpha, beta):
        with np.errstate(divide="ignore", invalid="ignore"):
            val = alpha * (beta * np.sqrt(alpha**2 + beta**2)
                           * (279 * alpha**6 + 326 * alpha**4 * beta**2
                              + 200 * alpha**2 * beta**4 + 48 * beta**6)
                           + 105 * alpha**8 * np.arcsinh(beta / np.where(alpha > 0, alpha, 1.0))
                           ) / 3456.0
        return np.where((alpha > 1e-30) & (beta > 1e-30), val, 0.0)

    for side in range(3):
        a_v = verts[:, side]                   # [T, 2]
        b_v = verts[:, (side + 1) % 3]
        d = b_v - a_v
        L2 = np.sum(d * d, axis=1)
        t = (np.einsum("tkj,tj->tk", centers - a_v[:, None, :], d)) / L2[:, None]
        foot = a_v[:, None, :] + t[..., None] * d[:, None, :]   # [T, k, 2]
        alpha = np.linalg.norm(centers - foot, axis=2)          # height
        beta1 = np.linalg.norm(foot - a_v[:, None, :], axis=2)
        beta2 = np.linalg.norm(foot - b_v[:, None, :], axis=2)

        # orientation signs of the two right triangles (O, foot, vertex)
        ca = a_v[:, None, :] - centers
        cf = foot - centers
        cb = b_v[:, None, :] - centers
        cross1 = ca[..., 0] * cf[..., 1] - ca[..., 1] * cf[..., 0]
        cross2 = cf[..., 0] * cb[..., 1] - cf[..., 1] * cb[..., 0]
        s1 = sABC[:, None] * np.sign(cross1)
        s2 = sABC[:, None] * np.sign(cross2)

        out += s1 * right_tri(alpha, beta1) + s2 * right_tri(alpha, beta2)
    return out


def surface_quadrature_weights(nodes, triangles, gradh=None):
    """Quadrature weights for surface integrals over the closed surface.

    ``nodes`` [N, 3] on the surface; ``triangles`` [T, 3] triangulation (e.g.
    scipy ConvexHull simplices); ``gradh`` callable giving the (unnormalized)
    exact surface normal at given points. Returns weights [N].
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    tris = np.sort(np.asarray(triangles), axis=1)
    N = len(nodes)
    k = min(N_NEIGHBORS, N)
    n_poly = (POLY_ORDER + 1) * (POLY_ORDER + 2) // 2
    assert k >= n_poly, "need more nodes than polynomial terms"

    tri_n = _triangle_normals(nodes, tris)
    edge_n = _edge_normals(nodes, tris, tri_n)
    proj_pt = _projection_points(nodes, tris, edge_n)
    mids = nodes[tris].mean(axis=1)
    tree = cKDTree(nodes)
    _, nni = tree.query(mids, k=k)

    if gradh is not None:
        ns_all = np.asarray(gradh(nodes), dtype=np.float64)
        ns_all /= np.linalg.norm(ns_all, axis=1, keepdims=True)
    else:
        raise NotImplementedError("approximate-normal branch not implemented; "
                                  "all framework shapes supply gradh")

    weights = np.zeros(N)
    T = len(tris)
    for lo in range(0, T, _CHUNK):
        hi = min(lo + _CHUNK, T)
        sl = slice(lo, hi)
        tn = tri_n[sl]                       # [t, 3]
        O = proj_pt[sl]                      # [t, 3]
        idx = nni[sl]                        # [t, k]
        pts = nodes[idx]                     # [t, k, 3]
        tv = nodes[tris[sl]]                 # [t, 3, 3]

        # project nodes onto the triangle plane along rays from O
        anchor = tv[:, 0]                    # a point on the plane
        denom = np.einsum("tj,tkj->tk", tn, pts - O[:, None, :])
        lam = np.einsum("tj,tkj->tk", tn, anchor[:, None, :] - pts) / denom
        proj = pts + lam[..., None] * (pts - O[:, None, :])   # [t, k, 3]

        # orthonormal in-plane basis
        ref = np.where(np.abs(tn[:, [0]]) < 0.9,
                       np.broadcast_to([1.0, 0.0, 0.0], tn.shape),
                       np.broadcast_to([0.0, 1.0, 0.0], tn.shape))
        e1 = np.cross(tn, ref)
        e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
        e2 = np.cross(tn, e1)

        # 2-D coordinates relative to the triangle midpoint (conditioning)
        mid = mids[sl]
        uv = np.stack([np.einsum("tkj,tj->tk", proj - mid[:, None, :], e1),
                       np.einsum("tkj,tj->tk", proj - mid[:, None, :], e2)], axis=-1)
        tuv = np.stack([np.einsum("tkj,tj->tk", tv - mid[:, None, :], e1),
                        np.einsum("tkj,tj->tk", tv - mid[:, None, :], e2)], axis=-1)

        I_rbf = _rbf_triangle_integrals(uv, tuv)          # [t, k]
        I_poly, exps = _polygon_monomial_integrals(tuv, POLY_ORDER)
        # orient polygon moments positively (unsigned area), matching the
        # sABC-corrected RBF integrals
        area2 = (tuv[:, 1, 0] - tuv[:, 0, 0]) * (tuv[:, 2, 1] - tuv[:, 0, 1]) \
            - (tuv[:, 2, 0] - tuv[:, 0, 0]) * (tuv[:, 1, 1] - tuv[:, 0, 1])
        I_poly *= np.sign(area2)[:, None]

        # saddle system [phi P; P^T 0]
        d2 = np.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, axis=-1)
        Phi = d2 ** 3.5                       # r^7
        P = np.stack([uv[..., 0] ** a * uv[..., 1] ** b for a, b in exps], axis=-1)
        nbig = k + n_poly
        Amat = np.zeros((hi - lo, nbig, nbig))
        Amat[:, :k, :k] = Phi
        Amat[:, :k, k:] = P
        Amat[:, k:, :k] = np.transpose(P, (0, 2, 1))
        rhs = np.concatenate([I_rbf, I_poly], axis=1)
        w = np.linalg.solve(Amat, rhs[..., None])[:, :k, 0]

        # area-element distortion: plane -> surface
        V = pts - O[:, None, :]
        rho = np.linalg.norm(V, axis=2)
        Vhat = V / rho[..., None]
        Rdist = np.linalg.norm(proj - O[:, None, :], axis=2)
        nS = ns_all[idx]
        cos_plane = np.einsum("tj,tkj->tk", tn, Vhat)
        cos_surf = np.einsum("tkj,tkj->tk", nS, Vhat)
        distort = np.abs(cos_plane / cos_surf * (rho / Rdist) ** 2)

        np.add.at(weights, idx.ravel(), (w * distort).ravel())

    return weights
