"""BVH: binned-SAH builder (host) + stackless walk (device).

The reference started a midpoint-split BVH and abandoned it — its
``Subdivide`` partitions triangles then throws ``NotImplementedException``
(Data/Collision/BVH.cs:49-81), and no traversal code exists at all; the
render path stayed brute force (Data/Objects/Scene.cs:64-115). This module
is the completed, batched version of that intent:

* **Builder** (C++ via ctypes, numpy fallback; host): top-down binned SAH
  (midpoint fallback) over the flattened mesh-triangle soup, emitting flat
  arrays. Node order is depth-first, so the "hit" successor of an interior
  node is implicitly ``i+1`` and a precomputed ``miss_next`` skip pointer
  threads the tree — the classic threaded/stackless layout.
* **Walk** (device): each ray carries ONE int cursor (no per-lane stack).
  Interior hit -> descend (cursor+1); miss or leaf -> follow ``miss_next``.
  Leaves hold <= ``leaf_size`` triangles. ``_walk_xla`` steps all rays in
  lockstep in a ``lax.while_loop``; ``ops/pallas/walk.py`` runs the same
  walk as one GPU kernel. ``traverse_any`` picks one through
  ``ops/backend.walk_route``. The ``t_enter <= best_t`` cull prunes far
  subtrees.

The walk is index logic — cut from autodiff by construction (int cursors);
gradients flow through the final gathered triangle hit exactly as in the
brute-force path (``_epilogue``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import pathlib
import subprocess
import sys
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unity_raytracer_tpu.ops.intersect import EPS, INF, dot3

LEAF_SIZE = 4
SAH_BINS = 16


# --- native (C++) builder backend ------------------------------------------
# native/bvh_builder.cc implements the same flat threaded layout as the
# numpy reference builder below, orders of magnitude faster on the 102k-tri
# flagship scene. Built from source at first use (``make -C native``) into
# native/build/ (git-ignored) and loaded via ctypes; the numpy path is the
# fallback, with a warning on stderr.

_NATIVE_LIB = None
_NATIVE_TRIED = False
_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
NATIVE_SO = _NATIVE_DIR / "build" / "libbvh.so"


def _build_native_so() -> None:
    """Compile native/bvh_builder.cc into ``NATIVE_SO``. The library is
    written under a per-process name and renamed into place, so
    concurrent first users (test workers) never load a half-written
    file."""
    NATIVE_SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = NATIVE_SO.with_name(f"libbvh.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR),
                        f"OUT={tmp}"], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, NATIVE_SO)
    finally:
        tmp.unlink(missing_ok=True)


def _native_lib():
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    try:
        if not NATIVE_SO.exists():
            _build_native_so()
        lib = ctypes.CDLL(str(NATIVE_SO))
    except (OSError, subprocess.SubprocessError) as e:
        print(f"unity_raytracer_tpu: native BVH builder unavailable ({e}); "
              f"using the numpy builder", file=sys.stderr)
        return None
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.urt_build_bvh_ex.restype = ctypes.c_int
    lib.urt_build_bvh_ex.argtypes = (
        [f32] + [ctypes.c_int] * 4 + [f32, f32, i32, i32, i32, i32])
    _NATIVE_LIB = lib
    return lib


def _build_native(tris: np.ndarray, leaf_size: int, use_sah: bool,
                  sah_bins: int = SAH_BINS):
    """Run the C++ builder; returns node arrays + prim order, or None."""
    lib = _native_lib()
    if lib is None:
        return None

    m = tris.shape[0]
    tris_f = np.ascontiguousarray(tris.reshape(m, 9), np.float32)
    max_nodes = 2 * m - 1 if m > 0 else 1
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty((max_nodes,), np.int32)
    count = np.empty((max_nodes,), np.int32)
    miss = np.empty((max_nodes,), np.int32)
    order = np.empty((m,), np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.urt_build_bvh_ex(
        p(tris_f, ctypes.c_float), m, leaf_size, int(use_sah),
        int(sah_bins),
        p(node_min, ctypes.c_float), p(node_max, ctypes.c_float),
        p(first, ctypes.c_int32), p(count, ctypes.c_int32),
        p(miss, ctypes.c_int32), p(order, ctypes.c_int32))
    if n <= 0:
        return None
    return (node_min[:n], node_max[:n], first[:n], count[:n], miss[:n],
            order)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshBVH:
    """Flat threaded BVH over the scene's concatenated mesh triangles.

    ``tri_verts`` are the triangles gathered into leaf order (so leaf prims
    are contiguous); ``prim_index`` maps leaf-order rows back to original
    ``MeshSet`` rows for identity/material lookups.
    """

    node_min: jnp.ndarray    # [Nn,3]
    node_max: jnp.ndarray    # [Nn,3]
    first: jnp.ndarray       # [Nn] leaf: first prim (leaf order); interior: -1
    count: jnp.ndarray       # [Nn] leaf: prim count; interior: 0
    miss_next: jnp.ndarray   # [Nn] skip pointer, -1 terminates
    tri_verts: jnp.ndarray   # [M,3,3] leaf-ordered triangles
    prim_index: jnp.ndarray  # [M] leaf-order -> original MeshSet row
    leaf_size: int = dataclasses.field(
        metadata=dict(static=True), default=LEAF_SIZE)
    # True when prepare_bvh canonicalized triangle winding so the shading
    # normal is re-derivable in the traversal epilogue as
    # ``-normalize(cross(v2-v0, v1-v0))`` (the reference bake convention,
    # SceneMesh.cs:43) — avoiding a [N]-ray gather from the [M]-row
    # normal table per segment. Swapping v1/v2 never changes the
    # intersection set (Moller-Trumbore is winding-symmetric here: no
    # backface cull, |det| test only).
    canonical: bool = dataclasses.field(
        metadata=dict(static=True), default=False)
    # [M_total] bool — which ORIGINAL mesh rows canonical_winding swapped
    # (v1<->v2). Stored so bind_verts can re-derive ``tri_verts`` from
    # the CURRENT scene mesh table differentiably (mesh-vertex fitting).
    flip: jnp.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return self.first.shape[0]


def _clip_tri_halfspaces(tri: np.ndarray, axis: np.ndarray,
                         split: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
    """Vectorized Sutherland–Hodgman clip of triangles against the
    axis-aligned plane ``x[axis] = split``, returning the AABBs of the
    two clipped polygons: (lo_left, hi_left, lo_right, hi_right).

    tri: [K,3,3]; axis: [K] int; split: [K]. A side with no vertices
    yields an inverted (empty) box.
    """
    k = tri.shape[0]
    coord = np.take_along_axis(
        tri, axis[:, None, None].repeat(3, 1), axis=2)[..., 0]  # [K,3]
    lo_l = np.full((k, 3), np.inf)
    hi_l = np.full((k, 3), -np.inf)
    lo_r = np.full((k, 3), np.inf)
    hi_r = np.full((k, 3), -np.inf)

    def acc(pmask, pts, lo, hi):
        p = np.where(pmask[:, None], pts, np.inf)
        np.minimum(lo, p, out=lo)
        p = np.where(pmask[:, None], pts, -np.inf)
        np.maximum(hi, p, out=hi)

    for i in range(3):
        j = (i + 1) % 3
        vi, vj = tri[:, i], tri[:, j]
        ci, cj = coord[:, i], coord[:, j]
        acc(ci <= split, vi, lo_l, hi_l)
        acc(ci >= split, vi, lo_r, hi_r)
        crosses = (ci - split) * (cj - split) < 0
        denom = np.where(np.abs(cj - ci) < 1e-30, 1e-30, cj - ci)
        t = np.clip((split - ci) / denom, 0.0, 1.0)
        pt = vi + t[:, None] * (vj - vi)
        # the intersection point lies exactly on the plane: force the
        # split coordinate so fp error can't leak the box across it
        np.put_along_axis(pt, axis[:, None], split[:, None], axis=1)
        acc(crosses, pt, lo_l, hi_l)
        acc(crosses, pt, lo_r, hi_r)
    return lo_l, hi_l, lo_r, hi_r


def presplit_refs(tris: np.ndarray, budget_frac: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SBVH-style spatial presplitting (Ernst–Greiner early split
    clipping): produce build REFERENCES (tri_index, clipped AABB) where
    oversized triangles appear multiple times with sub-boxes, letting
    the binned-SAH build below place each piece in the spatially right
    subtree instead of bloating one node's bounds.

    Returns (ref_tri [R], ref_lo [R,3], ref_hi [R,3]) with
    R <= len(tris) * (1 + budget_frac). Splits are taken largest-
    surface-area first, each at the midpoint of the ref box's longest
    axis, with the triangle polygon clipped to both halves (AABB of the
    clipped polygon, intersected with the parent ref box).
    """
    m = tris.shape[0]
    budget = int(m * budget_frac)
    ref_tri = np.arange(m, dtype=np.int64)
    ref_lo = tris.min(axis=1).astype(np.float64)
    ref_hi = tris.max(axis=1).astype(np.float64)
    while budget > 0:
        ext = ref_hi - ref_lo
        d = np.maximum(ext, 0)
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        k = min(budget, max(256, budget // 4))
        k = min(k, len(area))
        top = np.argpartition(area, -k)[-k:]
        # don't split refs already degenerate in their longest axis
        top = top[ext[top].max(axis=1) > 1e-12]
        if top.size == 0:
            break
        axis = np.argmax(ext[top], axis=1)
        split = 0.5 * (np.take_along_axis(ref_lo[top], axis[:, None], 1)
                       + np.take_along_axis(ref_hi[top], axis[:, None],
                                            1))[:, 0]
        t = tris[ref_tri[top]].astype(np.float64)
        lo_l, hi_l, lo_r, hi_r = _clip_tri_halfspaces(t, axis, split)
        # clamp each half to the parent ref box (refs may already be
        # tighter than the full triangle from earlier splits)
        lo_l = np.maximum(lo_l, ref_lo[top])
        hi_l = np.minimum(hi_l, ref_hi[top])
        lo_r = np.maximum(lo_r, ref_lo[top])
        hi_r = np.minimum(hi_r, ref_hi[top])
        ok = ((hi_l >= lo_l).all(1) & (hi_r >= lo_r).all(1))
        top, lo_l, hi_l, lo_r, hi_r = (top[ok], lo_l[ok], hi_l[ok],
                                       lo_r[ok], hi_r[ok])
        if top.size == 0:
            break
        ref_lo[top] = lo_l
        ref_hi[top] = hi_l
        ref_tri = np.concatenate([ref_tri, ref_tri[top]])
        ref_lo = np.concatenate([ref_lo, lo_r])
        ref_hi = np.concatenate([ref_hi, hi_r])
        budget -= top.size
    return (ref_tri.astype(np.int32), ref_lo.astype(np.float32),
            ref_hi.astype(np.float32))


def build(verts: np.ndarray, valid: np.ndarray | None = None,
          leaf_size: int = LEAF_SIZE, use_sah: bool = True,
          backend: str = "auto", sah_bins: int = SAH_BINS,
          aabb_pad: float = 0.0, presplit: float = 0.0) -> MeshBVH:
    """Build over triangle array [M,3,3]; invalid rows are excluded and the
    arrays re-padded with never-hit degenerate triangles.

    backend: 'auto' (native C++ if available, else numpy), 'native',
    'numpy'. Both backends emit the same threaded layout; tests assert
    traversal-identical results.

    ``aabb_pad``: inflate every node box by this margin. Makes the tree
    CONSERVATIVE for vertex deformations up to the pad — traversal
    against verts moved <= pad from their build positions stays exact
    (the mesh-vertex fitting story, fit.PARAM_PATHS 'mesh_verts').
    """
    verts = np.asarray(verts, np.float32)
    m_total = verts.shape[0]
    if valid is None:
        valid = np.ones((m_total,), bool)
    orig_idx = np.nonzero(np.asarray(valid))[0].astype(np.int32)
    tris = verts[orig_idx]
    m = tris.shape[0]
    if m == 0:
        # single empty leaf (its inverted box is never entered)
        return MeshBVH(
            node_min=jnp.full((1, 3), np.inf, jnp.float32),
            node_max=jnp.full((1, 3), -np.inf, jnp.float32),
            first=jnp.asarray([0], jnp.int32),
            count=jnp.asarray([0], jnp.int32),
            miss_next=jnp.asarray([-1], jnp.int32),
            tri_verts=jnp.zeros((1, 3, 3), jnp.float32),
            prim_index=jnp.zeros((1,), jnp.int32),
            leaf_size=leaf_size)

    if backend in ("auto", "native") and not presplit:
        res = _build_native(tris, leaf_size, use_sah, sah_bins)
        if res is not None:
            node_min, node_max, first_a, count_a, miss_a, order_a = res
            if aabb_pad:
                node_min = node_min - aabb_pad
                node_max = node_max + aabb_pad
            return MeshBVH(
                node_min=jnp.asarray(node_min),
                node_max=jnp.asarray(node_max),
                first=jnp.asarray(first_a),
                count=jnp.asarray(count_a),
                miss_next=jnp.asarray(miss_a),
                tri_verts=jnp.asarray(tris[order_a]),
                prim_index=jnp.asarray(orig_idx[order_a]),
                leaf_size=leaf_size)
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable "
                               "(g++/make failed?)")
        print("unity_raytracer_tpu: building the BVH with the numpy "
              "builder (slow at 100k triangles)", file=sys.stderr)

    if presplit:
        ref_tri, lo, hi = presplit_refs(tris, presplit)
        # SBVH binning keys off the REF BOX centroid (the clipped piece's
        # position), not the full triangle's vertex mean
        cent = 0.5 * (lo + hi)
        m = ref_tri.shape[0]
    else:
        ref_tri = np.arange(m, dtype=np.int32)
        lo = tris.min(axis=1)         # [m,3] per-tri AABB
        hi = tris.max(axis=1)
        # the reference's centroid used 0.3333f (Triangle.cs:23); for
        # splitting quality the exact factor is irrelevant — use the
        # true mean
        cent = tris.mean(axis=1)

    order = np.arange(m, dtype=np.int32)

    # node arrays, grown as lists (DFS emission order)
    n_min, n_max, n_first, n_count, n_parent_slot = [], [], [], [], []
    miss = []

    def emit(lo_, hi_):
        n_min.append(lo_)
        n_max.append(hi_)
        n_first.append(-1)
        n_count.append(0)
        miss.append(-1)
        return len(n_min) - 1

    def build_range(start: int, end: int) -> int:
        """DFS build of [start,end) of ``order``; returns node id."""
        idx = order[start:end]
        nlo = lo[idx].min(axis=0)
        nhi = hi[idx].max(axis=0)
        node = emit(nlo, nhi)
        n = end - start
        if n <= leaf_size:
            n_first[node] = start
            n_count[node] = n
            return node

        c = cent[idx]
        clo, chi = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        if chi[axis] - clo[axis] < 1e-12:
            # all centroids coincide: split by median index
            mid = start + n // 2
        else:
            mid = None
            if use_sah:
                mid = _sah_split(start, end, axis, c, idx)
            if mid is None:
                # midpoint fallback (the reference's intended strategy,
                # BVH.cs:60)
                split = 0.5 * (clo[axis] + chi[axis])
                mask = c[:, axis] < split
                k = int(mask.sum())
                if 0 < k < n:
                    part = np.concatenate([idx[mask], idx[~mask]])
                    order[start:end] = part
                    mid = start + k
                else:
                    mid = start + n // 2

        left = build_range(start, mid)
        right = build_range(mid, end)
        # thread: left's miss -> right; right's miss -> node's miss (patched
        # after the full build via a second pass)
        return node

    def _sah_split(start, end, axis, c, idx):
        """Binned SAH: returns global mid or None for fallback."""
        n = end - start
        cmin = c[:, axis].min()
        cmax = c[:, axis].max()
        if cmax - cmin < 1e-12:
            return None
        bins = np.clip(((c[:, axis] - cmin) / (cmax - cmin)
                        * sah_bins).astype(np.int32), 0, sah_bins - 1)
        # per-bin counts and bounds
        counts = np.zeros(sah_bins, np.int64)
        blo = np.full((sah_bins, 3), np.inf)
        bhi = np.full((sah_bins, 3), -np.inf)
        for b in range(sah_bins):
            sel = bins == b
            counts[b] = sel.sum()
            if counts[b]:
                blo[b] = lo[idx[sel]].min(axis=0)
                bhi[b] = hi[idx[sel]].max(axis=0)

        def area(l, h):
            d = np.maximum(h - l, 0)
            return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                        + d[..., 2] * d[..., 0])

        best_cost, best_b = np.inf, -1
        for b in range(1, sah_bins):
            cl, cr = counts[:b].sum(), counts[b:].sum()
            if cl == 0 or cr == 0:
                continue
            llo = blo[:b][counts[:b] > 0].min(axis=0)
            lhi = bhi[:b][counts[:b] > 0].max(axis=0)
            rlo = blo[b:][counts[b:] > 0].min(axis=0)
            rhi = bhi[b:][counts[b:] > 0].max(axis=0)
            cost = area(llo, lhi) * cl + area(rlo, rhi) * cr
            if cost < best_cost:
                best_cost, best_b = cost, b
        if best_b < 0:
            return None
        mask = bins < best_b
        k = int(mask.sum())
        if k == 0 or k == n:
            return None
        part = np.concatenate([idx[mask], idx[~mask]])
        order[start:end] = part
        return start + k

    build_range(0, m)

    n_first_arr = np.asarray(n_first, np.int32)
    n_count_arr = np.asarray(n_count, np.int32)
    nn = len(n_min)

    # second pass: compute miss_next by DFS with an explicit stack, using
    # subtree extents (DFS order => subtree of node i occupies a contiguous
    # range; its end = i + subtree_size)
    subtree = np.ones(nn, np.int64)
    # compute subtree sizes bottom-up: walk nodes in reverse; a leaf is 1;
    # an interior node's subtree = 1 + left_subtree + right_subtree where
    # left = i+1 and right = i+1+subtree[left]
    for i in range(nn - 1, -1, -1):
        if n_count_arr[i] == 0:  # interior
            l = i + 1
            r = l + subtree[l]
            subtree[i] = 1 + subtree[l] + subtree[r]
    miss_arr = np.full(nn, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        i, miss_of_i = stack.pop()
        miss_arr[i] = miss_of_i
        if n_count_arr[i] == 0:
            l = i + 1
            r = l + int(subtree[l])
            stack.append((l, r))          # left's miss -> right
            stack.append((r, miss_of_i))  # right's miss -> node's miss

    tri_leaf_order = tris[ref_tri[order]]
    prim_index = orig_idx[ref_tri[order]]

    nmin_arr = np.asarray(n_min, np.float32)
    nmax_arr = np.asarray(n_max, np.float32)
    if aabb_pad:
        nmin_arr = nmin_arr - aabb_pad
        nmax_arr = nmax_arr + aabb_pad
    return MeshBVH(
        node_min=jnp.asarray(nmin_arr),
        node_max=jnp.asarray(nmax_arr),
        first=jnp.asarray(n_first_arr),
        count=jnp.asarray(n_count_arr),
        miss_next=jnp.asarray(miss_arr),
        tri_verts=jnp.asarray(tri_leaf_order),
        prim_index=jnp.asarray(prim_index),
        leaf_size=leaf_size)


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------

def _slab_enter(o, d_inv, lo, hi, tmax):
    """Slab test over [0, tmax]: returns (hit, t_enter).

    ``d_inv`` must be finite (see `_safe_inv`): an axis-parallel ray with
    origin exactly on a slab plane would otherwise produce 0*inf = NaN and
    silently cull the node.
    """
    t1 = (lo - o) * d_inv
    t2 = (hi - o) * d_inv
    tn = jnp.minimum(t1, t2)
    tf = jnp.maximum(t1, t2)
    t_enter = jnp.maximum(
        jnp.maximum(jnp.maximum(tn[:, 0], tn[:, 1]), tn[:, 2]), 0.0)
    t_exit = jnp.minimum(
        jnp.minimum(jnp.minimum(tf[:, 0], tf[:, 1]), tf[:, 2]), tmax)
    return (t_enter <= t_exit), t_enter


def _safe_inv(d: jnp.ndarray) -> jnp.ndarray:
    """1/d with zero components clamped to +/-1e-30 so the slab products
    stay NaN-free (0 * 1e30 = 0, never 0 * inf)."""
    tiny = jnp.float32(1e-30)
    safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    return 1.0 / safe


def _mt_one(o, d, v0, v1, v2):
    """Moller-Trumbore for one gathered triangle per ray ([N,3] each).
    Same rejects/epsilons as ops.intersect.ray_triangles."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = jnp.cross(d, e2)
    a = dot3(e1, h)
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0
    u = f * dot3(s, h)
    q = jnp.cross(s, e1)
    v = f * dot3(d, q)
    t = f * dot3(e2, q)
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (t <= EPS))
    return jnp.where(miss, INF, t)


def shading_normal(tri: jnp.ndarray) -> jnp.ndarray:
    """Reference mesh-bake shading normal from gathered tri verts [N,3,3]:
    ``-normalize(cross(v2-v0, v1-v0))`` (SceneMesh.cs:43 flip convention;
    winding canonicalized by prepare_bvh). Junk on miss lanes — mask it."""
    e1 = tri[:, 2] - tri[:, 0]
    e2 = tri[:, 1] - tri[:, 0]
    nml = -jnp.cross(e1, e2)
    return nml * jax.lax.rsqrt(
        jnp.maximum(dot3(nml, nml), 1e-60))[:, None]


def _walk_xla(bvh: MeshBVH, o: jnp.ndarray, d: jnp.ndarray,
              t_max: jnp.ndarray | None = None, any_hit: bool = False
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The stackless walk as one ``lax.while_loop`` over all lanes ->
    ``(best_t [N], best_i [N])``: best_t seeded with ``t_max`` (negative
    culls the lane), best_i the winning leaf-order row or -1."""
    n = o.shape[0]
    d_inv = _safe_inv(d)
    best_t0 = jnp.full((n,), jnp.inf, jnp.float32) if t_max is None \
        else jnp.asarray(t_max, jnp.float32)

    def cond(state):
        cursor, _, _ = state
        return jnp.any(cursor >= 0)

    def body(state):
        cursor, best_t, best_i = state
        active = cursor >= 0
        node = jnp.clip(cursor, 0, bvh.n_nodes - 1)
        nlo = jnp.take(bvh.node_min, node, axis=0)
        nhi = jnp.take(bvh.node_max, node, axis=0)
        first = jnp.take(bvh.first, node)
        count = jnp.take(bvh.count, node)
        miss_next = jnp.take(bvh.miss_next, node)

        box_hit, _ = _slab_enter(o, d_inv, nlo, nhi, best_t)
        box_hit = box_hit & active
        is_leaf = first >= 0    # interior nodes carry first == -1

        # static unrolled leaf loop (builder caps leaf size)
        for k in range(bvh.leaf_size):
            pi = jnp.clip(first + k, 0, bvh.tri_verts.shape[0] - 1)
            tri = jnp.take(bvh.tri_verts, pi, axis=0)     # [N,3,3]
            t = _mt_one(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
            upd = box_hit & is_leaf & (k < count) & (t < best_t)
            best_t = jnp.where(upd, -1.0 if any_hit else t, best_t)
            best_i = jnp.where(upd, pi.astype(jnp.int32), best_i)

        descend = box_hit & ~is_leaf
        cursor = jnp.where(active,
                           jnp.where(descend, cursor + 1, miss_next),
                           cursor)
        if any_hit:  # occluded lanes retire immediately
            cursor = jnp.where(best_t < 0.0, -1, cursor)
        return cursor, best_t, best_i

    # lanes culled on input (t_max < 0) never enter the tree
    cursor0 = jnp.where(best_t0 < 0.0, -1, 0).astype(jnp.int32) \
        if t_max is not None else jnp.zeros((n,), jnp.int32)
    best_i0 = jnp.full((n,), -1, jnp.int32)
    _, best_t, best_i = jax.lax.while_loop(
        cond, body, (cursor0, jax.lax.stop_gradient(best_t0), best_i0))
    return best_t, best_i


def _epilogue(bvh: MeshBVH, o: jnp.ndarray, d: jnp.ndarray,
              best_t: jnp.ndarray, best_i: jnp.ndarray
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Walk result -> ``(t, original prim index, shading normal)``.

    The walk is not reverse-mode differentiable (while_loop / Pallas);
    it is pure index logic, so its t is cut here and the winner's t is
    re-derived differentiably from the gathered triangle — gradients flow
    through the verts exactly like the brute-force path."""
    best_t = jax.lax.stop_gradient(best_t)
    orig = jnp.where(best_i >= 0,
                     jnp.take(bvh.prim_index, jnp.clip(best_i, 0, None)),
                     -1)
    safe_row = jnp.clip(best_i, 0, None)
    tri = jnp.take(bvh.tri_verts, safe_row, axis=0)
    t_diff = _mt_one(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
    hit = best_i >= 0
    t_out = jnp.where(hit, jnp.where(jnp.isfinite(t_diff), t_diff, best_t),
                      jnp.inf)
    return t_out, orig.astype(jnp.int32), shading_normal(tri)


def traverse(bvh: MeshBVH, o: jnp.ndarray, d: jnp.ndarray,
             t_max: jnp.ndarray | None = None,
             any_hit: bool = False
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest mesh-triangle hit via the XLA walk.

    Returns ``(t [N], original_prim_index [N], shading_normal [N,3])``
    with +inf / -1 / junk on miss. The normal is re-derived from the
    winning triangle's verts (one cross product on data the t re-derivation
    already gathered) — meaningful only when ``bvh.canonical``.
    ``t_max`` optionally seeds the cull distance (shadow queries pass the
    light distance so far subtrees prune immediately); a negative ``t_max``
    culls the lane entirely. ``any_hit`` finishes a lane at its first
    occluder closer than ``t_max`` (occlusion queries only — the returned t
    is a valid occluder distance, not the minimum).
    """
    best_t, best_i = _walk_xla(bvh, o, d, t_max=t_max, any_hit=any_hit)
    return _epilogue(bvh, o, d, best_t, best_i)


def canonical_winding(verts: np.ndarray, normals: np.ndarray,
                      return_flip: bool = False) -> np.ndarray:
    """Swap v1/v2 of triangles whose derived normal opposes the stored
    shading normal, so ``shading_normal`` (the -cross bake convention,
    SceneMesh.cs:43) reproduces the stored normals without a per-ray
    gather. The swap is intersection-invariant (see MeshBVH.canonical).
    ``return_flip``: also return the per-row swap mask (stored on
    MeshBVH.flip so bind_verts can re-apply it differentiably)."""
    v = np.array(verts, np.float32, copy=True)
    nc = -np.cross(v[:, 2] - v[:, 0], v[:, 1] - v[:, 0])
    flip = np.sum(nc * np.asarray(normals, np.float32), axis=-1) < 0.0
    v[flip] = v[flip][:, [0, 2, 1]]
    return (v, flip) if return_flip else v


def bind_verts(bvh: MeshBVH, scene) -> MeshBVH:
    """Differentiably re-derive the walk epilogue's triangle table from
    the CURRENT scene mesh verts — the mesh-vertex gradient hook
    (fit.PARAM_PATHS 'mesh_verts').

    Walk decisions (which node, which winner) run on ``stop_gradient``
    data; the epilogue's differentiable t / shading-normal re-derivation
    then reads this bound table, so d(radiance)/d(mesh verts) flows
    exactly like the brute-force path. When the verts are NOT a traced
    parameter the gather constant-folds at compile time — binding is free
    for ordinary renders.

    Caveat (documented mesh-fitting contract): build the BVH with
    ``aabb_pad >= max vertex displacement`` (cfg.bvh_pad) so the padded
    node boxes stay conservative and the forward remains exact while
    verts move.
    """
    if scene.meshes.count == 0:
        return bvh
    v = scene.meshes.verts
    if bvh.flip is not None:
        v = jnp.where(bvh.flip[:, None, None], v[:, (0, 2, 1), :], v)
    tri = jnp.take(v, jnp.clip(bvh.prim_index, 0, None), axis=0)
    return dataclasses.replace(bvh, tri_verts=tri)


def prepare_bvh(scene, cfg) -> MeshBVH:
    """Build the scene's mesh BVH — the one layout both walks read.
    Call host-side on a concrete scene. Triangle winding is canonicalized
    against the scene's stored shading normals so the walk epilogue
    re-derives normals for free."""
    verts, flip = canonical_winding(np.asarray(scene.meshes.verts),
                                    np.asarray(scene.meshes.normals),
                                    return_flip=True)
    b = build(verts, np.asarray(scene.meshes.valid),
              leaf_size=cfg.bvh_leaf, sah_bins=cfg.bvh_bins,
              aabb_pad=cfg.bvh_pad, presplit=cfg.bvh_presplit)
    return dataclasses.replace(b, canonical=True, flip=jnp.asarray(flip))


def traverse_any(bvh: MeshBVH, o: jnp.ndarray, d: jnp.ndarray,
                 t_max: jnp.ndarray | None = None,
                 kernel: str = "auto",
                 any_hit: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Walk routed by ``ops/backend.walk_route(kernel)`` ->
    ``(t, prim index, shading normal)`` as in ``traverse``.

    ``any_hit`` (occlusion queries): lanes finish at the first occluder
    closer than ``t_max``; a negative ``t_max`` culls a lane outright.
    """
    from unity_raytracer_tpu.ops.backend import walk_route
    route, interpret = walk_route(kernel)
    if route == "xla":
        return traverse(bvh, o, d, t_max=t_max, any_hit=any_hit)
    from unity_raytracer_tpu.ops.pallas.walk import walk
    if t_max is None:
        t_max = jnp.full((o.shape[0],), jnp.inf, jnp.float32)
    best_t, best_i = walk(bvh, o, d, t_max, any_hit=any_hit,
                          interpret=interpret)
    return _epilogue(bvh, o, d, best_t, best_i)
