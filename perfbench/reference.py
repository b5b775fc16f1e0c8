"""The plain reference of a fitting step, in PyTorch and NumPy.

It imports nothing of the program.  From the scene alone it works out what
the program computes in a step of ``optimize_shape``, on a ``smooth`` leg
(the parameters are u = M v) or on a coordinate leg (``smooth`` off: the
parameters are the welded vertices v themselves):

* the mesh welded (``np.unique`` of the rows), the uniform Laplacian and,
  on a ``smooth`` leg, ``M = I + λL`` or ``(1 − α)I + αL``, in float64;
* on a ``smooth`` leg the solve ``v = M⁻¹u`` and its adjoint by conjugate
  gradients in float64 (:class:`Solve`); on a coordinate leg none;
* angle-weighted vertex normals;
* the render: projection, a z-buffer over each face's pixel box (the
  nearest face wins, the lowest id on a tie), perspective-correct
  barycentrics, spherical-harmonics shading, the environment backgrounds,
  and the analytic silhouette antialias over every pair of neighbouring
  pixels with the position-gradient boost (the semantics of
  nvdiffrast's ``rasterize``/``interpolate``/``antialias``, as the port's
  dense renderer and tile kernels state them), differentiated by autograd;
* the l1 or l2 image loss and the Laplacian term;
* AdamUniform or Adam.

``lowp=True`` computes the same in the precision below the configuration's
float32: every tensor a stage hands on (solved vertices, normals, clip
positions, shading, images) and every gradient it hands back rounded to
TF32's 10-bit mantissa, as a TF32 product rounds its inputs.  That is the
comparison's control (``check.py``).

:func:`count_work` counts, from the same rasterization, the work of the
four tile kernels for ``roofline.py``.
"""
from __future__ import annotations

import math
import statistics
import warnings

import numpy as np
import torch

__all__ = ["Reference", "Optimizer", "tf32", "count_work", "count_clip",
           "leaf_gap", "row_gap"]

BIG = 3.4e38
# faults a side in the program's place can carry (check.py): the state
# left unchanged by each step, half of the views left out of the loss
# (its mean over the rest), every view's image one row off (a tile row
# offset wrong by one)
FAULTS = (None, "freeze", "half_views", "roll_row")
_ABS_MASK = 0x7FFFFFFF


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0xFFF + lsb) & ~0x1FFF
    keep = (b & 0x7F800000) == 0x7F800000           # inf and NaN
    return torch.where(keep, b, r).view(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


def _lp(x, lowp):
    return _Round.apply(x) if lowp else x


# --- mesh, Laplacian, solve -------------------------------------------------

def weld(v, f):
    """(unique rows sorted, faces on them, index of each source vertex)."""
    uv, inv = np.unique(np.asarray(v), axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return uv, inv[np.asarray(f, np.int64)], inv


def laplacian(n: int, faces) -> tuple:
    """The uniform Laplacian D − A of the mesh's unique edges: (rows,
    cols, values) in float64."""
    f = np.asarray(faces, np.int64)
    i = f[:, [1, 2, 0]].reshape(-1)
    j = f[:, [2, 0, 1]].reshape(-1)
    key = np.unique(np.concatenate([i * n + j, j * n + i]))
    src, dst = key // n, key % n
    deg = np.bincount(src, minlength=n).astype(np.float64)
    d = np.arange(n)
    return (np.concatenate([src, d]), np.concatenate([dst, d]),
            np.concatenate([-np.ones(len(src)), deg]))


def face_adjacency(faces) -> np.ndarray:
    """For edge e = (f[e], f[e+1]) of each face, the lowest other face on
    that edge, or −1."""
    f = np.asarray(faces, np.int64)
    F = len(f)
    a = f.reshape(-1)
    b = f[:, [1, 2, 0]].reshape(-1)
    n = int(f.max()) + 1
    key = np.minimum(a, b) * n + np.maximum(a, b)
    face = np.repeat(np.arange(F), 3)
    order = np.lexsort((face, key))
    ks, fs = key[order], face[order]
    start = np.r_[0, np.flatnonzero(ks[1:] != ks[:-1]) + 1]
    size = np.diff(np.r_[start, len(ks)])
    grp = np.repeat(np.arange(len(start)), size)
    g0 = fs[start][grp]
    g1 = np.where(size > 1, fs[np.minimum(start + 1, len(ks) - 1)], -1)[grp]
    opp_sorted = np.where(fs == g0, g1, g0)
    opp = np.empty(3 * F, np.int64)
    opp[order] = opp_sorted
    return opp.reshape(F, 3)


class SPD:
    """A symmetric positive definite sparse matrix in float64 on a device,
    and conjugate gradients on it."""

    def __init__(self, rows, cols, vals, n, device):
        idx = torch.as_tensor(np.stack([rows, cols]), device=device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # CSR is "beta"
            self.A = torch.sparse_coo_tensor(
                idx, torch.as_tensor(vals, dtype=torch.float64,
                                     device=device), (n, n),
                check_invariants=False).coalesce().to_sparse_csr()
        self.n = n

    def mv(self, x):
        return self.A @ x

    def cg(self, b, tol=1e-12, max_iter=20000):
        """x with ‖Ax − b‖ ≤ tol ‖b‖ per column (float64, b (n, k))."""
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rr = (r * r).sum(0)
        stop = (tol ** 2) * rr
        for _ in range(max_iter):
            if bool((rr <= stop).all()):
                break
            Ap = self.mv(p)
            alpha = rr / (p * Ap).sum(0).clamp_min(1e-300)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = (r * r).sum(0)
            p = r + (rr_new / rr.clamp_min(1e-300)) * p
            rr = rr_new
        else:
            raise RuntimeError("reference CG did not converge")
        return x


class Solve(torch.autograd.Function):
    """v = M⁻¹u in float64, differentiable (M is symmetric)."""

    @staticmethod
    def forward(ctx, u, M):
        ctx.M = M
        return M.cg(u.double()).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.M.cg(g.double()).to(g.dtype), None


class _SpMV(torch.autograd.Function):
    """L v in float64 for a symmetric L, differentiable in v."""

    @staticmethod
    def forward(ctx, v, L):
        ctx.L = L
        return L.mv(v.double()).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.L.mv(g.double()).to(g.dtype), None


# --- normals, shading, cameras ----------------------------------------------

def _unit(a):
    return a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-20)


def vertex_normals(v, f):
    """Angle-weighted unit vertex normals (V, 3); f (F, 3) int64."""
    fv = v[f]                                        # (F, 3, 3)
    fn = _unit(torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0],
                                  dim=1))
    out = torch.zeros_like(v)
    for i in range(3):
        d0 = _unit(fv[:, (i + 1) % 3] - fv[:, i])
        d1 = _unit(fv[:, (i + 2) % 3] - fv[:, i])
        ang = torch.arccos(torch.clamp((d0 * d1).sum(1), -1.0 + 1e-6,
                                       1.0 - 1e-6))
        out = out.index_add(0, f[:, i], fn * ang[:, None])
    return _unit(out)


def sh_matrices(envmap) -> torch.Tensor:
    """(3, 4, 4) quadratic forms of the order-2 SH irradiance of an
    equirectangular map (Ramamoorthi and Hanrahan), float32 on the host."""
    env = torch.as_tensor(np.asarray(envmap, np.float32))
    h, w = env.shape[:2]
    theta = torch.linspace(0.0, np.pi, h)[:, None] * torch.ones((1, w))
    phi = torch.ones((h, 1)) * torch.linspace(3 * np.pi, np.pi, w)[None, :]
    st = torch.sin(theta)
    x, z, y = st * torch.cos(phi), -st * torch.sin(phi), torch.cos(theta)
    Y = {"0": 0.282095 * torch.ones_like(x), "1-1": 0.488603 * z,
         "10": 0.488603 * x, "11": 0.488603 * y,
         "20": 0.315392 * (3 * z * z - 1), "21": 1.092548 * x * z,
         "22": 0.546274 * (x * x - y * y), "2-2": 1.092548 * x * y,
         "2-1": 1.092548 * y * z}
    dt_dp = 2.0 * np.pi ** 2 / (w * h)
    L = {k: (env[..., :3] * y_[..., None] * st[..., None] * dt_dp).sum((0, 1))
         for k, y_ in Y.items()}
    c1, c2, c3, c4, c5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708
    M = torch.stack([
        torch.stack([c1 * L["22"], c1 * L["2-2"], c1 * L["21"], c2 * L["11"]]),
        torch.stack([c1 * L["2-2"], -c1 * L["22"], c1 * L["2-1"],
                     c2 * L["1-1"]]),
        torch.stack([c1 * L["21"], c1 * L["2-1"], c3 * L["20"], c2 * L["10"]]),
        torch.stack([c2 * L["11"], c2 * L["1-1"], c2 * L["10"],
                     c4 * L["0"] - c5 * L["20"]]),
    ])
    return torch.movedim(M, 2, 0).contiguous()


def sh_eval(M, n):
    h = torch.cat([n, torch.ones_like(n[:, :1])], 1)
    return torch.einsum("vi,cvi->vc", h, torch.einsum("cij,vj->cvi", M, h))


def _bilinear(tex, uv):
    H, W = tex.shape[:2]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    def at(xi, yi):
        return tex[torch.clamp(yi.long(), 0, H - 1),
                   torch.clamp(xi.long(), 0, W - 1)]

    return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)


def backgrounds(envmap, view_mats, fov, res):
    """(C, H, W, 4) environment seen behind each pixel, alpha 0."""
    h, w = res
    env = torch.as_tensor(np.asarray(envmap, np.float32))
    views = torch.as_tensor(np.asarray(view_mats, np.float32))
    tan_a = np.tan(np.deg2rad(fov) / 2.0)
    xs = (torch.arange(w, dtype=torch.float32) + 0.5) / w * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32) + 0.5) / h * 2.0 - 1.0
    xn, yn = xs[None, :].expand(h, w), ys[:, None].expand(h, w)
    d = torch.stack([-xn * tan_a, yn * tan_a / (w / h), torch.ones_like(xn)],
                    -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dw = torch.einsum("cij,hwj->chwi", torch.linalg.inv(views)[:, :3, :3], d)
    theta = torch.arccos(torch.clamp(dw[..., 1], -1.0, 1.0))
    phi = torch.arctan2(dw[..., 0], dw[..., 2])
    bg = _bilinear(env, torch.stack([0.75 - phi / (2 * np.pi), theta / np.pi],
                                    -1))
    bg[..., -1] = 0.0
    return bg


def mvps(scene) -> np.ndarray:
    """(C, 4, 4) projection × view (OpenGL-style, x negated)."""
    fov, near, far = scene["fov"], scene["near_clip"], scene["far_clip"]
    ar = scene["res_x"] / scene["res_y"]
    t = np.tan(np.deg2rad(fov) / 2.0)
    proj = np.array([[-1.0 / t, 0, 0, 0], [0, ar / t, 0, 0],
                     [0, 0, -(near + far) / (near - far),
                      2 * far * near / (near - far)], [0, 0, 1, 0]],
                    dtype=np.float32)
    views = np.stack([np.asarray(m) for m in scene["view_mats"]])
    return np.einsum("ij,cjk->cik", proj, views).astype(np.float32)


def project(v, m):
    """(V, 3) × (C, 4, 4) → (C, V, 4) clip coordinates."""
    m = m[:, None]
    x, y, z = (v[None, :, None, k] for k in range(3))
    return ((m[..., 0] * x + m[..., 1] * y) + m[..., 2] * z) + m[..., 3]


# --- rasterization ----------------------------------------------------------

def _grid(n, device):
    k = torch.full((), float(n), dtype=torch.float32, device=device)
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / k \
        * 2.0 - 1.0


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def planes(tri):
    """Each face's screen-space planes from its clip corners tri (..., 3,
    4), differentiable: (..., 12) = the homogeneous barycentrics q0, q1,
    their sum s (1/w, perspective-correct) and the depth z/w, each as
    a·x + b·y + c over the pixel centre (x, y) in NDC; a face behind the
    camera or of no area never covers (q0 = −1).  Evaluated at a pixel by
    :func:`at`: covered where q0, q1, s − q0 − q1 ≥ 0 and s > 0; then
    u = q0/s, v = q1/s."""
    w = tri[..., 3]
    valid = torch.all(w > 1e-9, dim=-1)
    safe = torch.where(w == 0, torch.ones_like(w), w)
    zero = torch.zeros_like(w)
    ok = valid[..., None]
    iw = torch.where(ok, 1.0 / safe, zero)
    sx = torch.where(ok, tri[..., 0] / safe, zero)
    sy = torch.where(ok, tri[..., 1] / safe, zero)
    zw = torch.where(ok, tri[..., 2] / safe, zero)
    x, y = (lambda k: sx[..., k]), (lambda k: sy[..., k])
    area = (x(1) - x(0)) * (y(2) - y(0)) - (y(1) - y(0)) * (x(2) - x(0))
    valid = valid & (torch.abs(area) >= 1e-12)
    one = torch.ones_like(area)
    inv = torch.where(valid, 1.0 / torch.where(area == 0, one, area),
                      torch.zeros_like(area))
    b0a = -(y(2) - y(1)) * inv
    b0b = (x(2) - x(1)) * inv
    b0c = (x(1) * (y(2) - y(1)) - y(1) * (x(2) - x(1))) * inv
    b1a = -(y(0) - y(2)) * inv
    b1b = (x(0) - x(2)) * inv
    b1c = (x(2) * (y(0) - y(2)) - y(2) * (x(0) - x(2))) * inv
    i0, i1, i2 = iw[..., 0], iw[..., 1], iw[..., 2]
    d02, d12 = i0 - i2, i1 - i2
    z02, z12 = zw[..., 0] - zw[..., 2], zw[..., 1] - zw[..., 2]
    return torch.stack([
        b0a * i0, b0b * i0, torch.where(valid, b0c * i0, -one),
        b1a * i1, b1b * i1, torch.where(valid, b1c * i1, -one),
        b0a * d02 + b1a * d12, b0b * d02 + b1b * d12,
        b0c * d02 + b1c * d12 + i2,
        b0a * z02 + b1a * z12, b0b * z02 + b1b * z12,
        b0c * z02 + b1c * z12 + zw[..., 2]], dim=-1)


def at(pl, px, py):
    """(q0, q1, s, depth, covered) of planes ``pl`` (..., 12) at pixel
    centres (px, py) broadcast against them."""
    e = lambda k: (pl[..., k] * px + pl[..., k + 1] * py) + pl[..., k + 2]
    q0, q1, s, d = e(0), e(3), e(6), e(9)
    q2 = (s - q0) - q1
    cov = (q0 >= 0.0) & (q1 >= 0.0) & (q2 >= 0.0) & (s > 0.0) & (d < BIG)
    return q0, q1, s, d, cov


def _sortable(d):
    b = d.contiguous().view(torch.int32)
    return (b ^ ((b >> 31) & _ABS_MASK)).to(torch.int64)


@torch.no_grad()
def zbuffer(clip, faces, res, budget=1 << 23):
    """Face id + 1 (0: background) and depth of the nearest covering face
    at each pixel (C, H, W), the lowest id on a tie, tested over the pixel
    centres inside each face's screen box (a thousandth of a pixel of
    slack); also the boxes' pixel counts (the z-tests) a camera.
    ``faces`` (F, 3) int64."""
    H, W = res
    C, dev = clip.shape[0], clip.device
    xs, ys = _grid(W, dev), _grid(H, dev)
    F = faces.shape[0]
    ids = torch.zeros((C, H * W), dtype=torch.int64, device=dev)
    zb = torch.zeros((C, H * W), dtype=torch.float32, device=dev)
    tests = torch.zeros(C, dtype=torch.float64, device=dev)
    empty = torch.iinfo(torch.int64).max
    for c in range(C):
        tri = clip[c][faces]                           # (F, 3, 4)
        pl = planes(tri)
        w = tri[..., 3]
        sx, sy = tri[..., 0] / w, tri[..., 1] / w
        ok = torch.all(w > 1e-9, -1) & torch.isfinite(sx).all(-1) \
            & torch.isfinite(sy).all(-1)
        j0 = torch.ceil((sx.amin(-1) + 1.0) * (W / 2.0) - 0.5 - 1e-3)
        j1 = torch.floor((sx.amax(-1) + 1.0) * (W / 2.0) - 0.5 + 1e-3)
        i0 = torch.ceil((sy.amin(-1) + 1.0) * (H / 2.0) - 0.5 - 1e-3)
        i1 = torch.floor((sy.amax(-1) + 1.0) * (H / 2.0) - 0.5 + 1e-3)
        j0 = torch.nan_to_num(j0).clamp(0, W - 1)
        i0 = torch.nan_to_num(i0).clamp(0, H - 1)
        j1 = torch.nan_to_num(j1).clamp(-1, W - 1)
        i1 = torch.nan_to_num(i1).clamp(-1, H - 1)
        nx = torch.where(ok, (j1 - j0 + 1).clamp(min=0), 0).long()
        ny = torch.where(ok, (i1 - i0 + 1).clamp(min=0), 0).long()
        n = nx * ny
        tests[c] = n.sum().double()
        best = torch.full((H * W,), empty, dtype=torch.int64, device=dev)
        cum = torch.cumsum(n, 0)
        total = int(cum[-1]) if F else 0
        lo = 0
        while lo < total:
            hi = min(total, lo + budget)
            k = torch.arange(lo, hi, device=dev)
            fi = torch.searchsorted(cum, k, right=True)
            off = k - (cum[fi] - n[fi])
            jj = j0[fi].long() + off % nx[fi]
            ii = i0[fi].long() + off // nx[fi]
            _, _, _, depth, cov = at(pl[fi], xs[jj], ys[ii])
            key = (_sortable(depth) * (1 << 32)) | (fi + 1)
            best.scatter_reduce_(0, (ii * W + jj)[cov], key[cov], "amin")
            lo = hi
        hit = best != empty
        fid = torch.where(hit, best & 0xFFFFFFFF, 0)
        ids[c] = fid
        t = torch.clamp(fid - 1, min=0)
        _, _, _, depth, _ = at(pl[t], xs.repeat(H), ys.repeat_interleave(W))
        zb[c] = torch.where(hit, depth, 0.0)
    return ids.reshape(C, H, W), zb.reshape(C, H, W), tests


def _pairs(ids, zb, clip, faces, opp, res, boost):
    """The antialias of every pair of neighbouring pixels: for each
    direction, (a index, b index, owner's crossing t, active, owner id) over
    the flattened (C, H·W) planes; t carries the gradient of the owner's
    edge endpoints, multiplied by ``boost``."""
    H, W = res
    C, dev = clip.shape[0], clip.device
    xs, ys = _grid(W, dev), _grid(H, dev)
    cb = clip if boost == 1.0 else clip.detach() + boost * (clip
                                                             - clip.detach())
    w = cb[..., 3]
    safe = torch.where(w == 0, 1.0, w)
    sx, sy = cb[..., 0] / safe, cb[..., 1] / safe
    w_ok = w.detach() > 1e-9
    idf, zf = ids.reshape(C, -1), zb.reshape(C, -1)
    cam = torch.arange(C, device=dev)[:, None]
    out = []
    rr, cc = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    for da, db in (((slice(None), slice(0, W - 1)),
                    (slice(None), slice(1, W))),
                   ((slice(0, H - 1), slice(None)),
                    (slice(1, H), slice(None)))):
        ia = (rr[da] * W + cc[da]).reshape(-1)
        ib = (rr[db] * W + cc[db]).reshape(-1)
        pax, pay = xs[ia % W], ys[ia // W]
        pbx, pby = xs[ib % W], ys[ib // W]
        id_a, id_b = idf[:, ia], idf[:, ib]
        da_ = torch.where(id_a > 0, zf[:, ia], BIG)
        db_ = torch.where(id_b > 0, zf[:, ib], BIG)
        own_a = da_ <= db_
        owner = torch.where(own_a, id_a, id_b)
        other = torch.where(own_a, id_b, id_a)
        tri = torch.clamp(owner - 1, min=0)
        fv, fo = faces[tri], opp[tri]
        best_ok = torch.zeros(tri.shape, dtype=torch.bool, device=dev)
        best_t = torch.zeros(tri.shape, dtype=clip.dtype, device=dev)
        for e in range(3):
            va, vb = fv[..., e], fv[..., (e + 1) % 3]
            ax, ay = sx[cam, va], sy[cam, va]
            bx, by = sx[cam, vb], sy[cam, vb]
            ex, ey = bx - ax, by - ay
            ea = ex * (pay - ay) - ey * (pax - ax)
            eb = ex * (pby - ay) - ey * (pbx - ax)
            sep = (ea > 0) != (eb > 0)
            den = ea - eb
            t = ea / torch.where(den == 0, 1.0, den)
            with torch.no_grad():
                cx = pax + t * (pbx - pax)
                cy = pay + t * (pby - pay)
                along = (cx - ax) * ex + (cy - ay) * ey
                within = (along >= 0) & (along <= ex * ex + ey * ey)
            sil = (other == 0) | (fo[..., e] != (other - 1))
            ok = sep & within & sil & w_ok[cam, va] & w_ok[cam, vb]
            best_t = torch.where(ok & ~best_ok, t, best_t)
            best_ok = best_ok | ok
        active = (id_a != id_b) & (owner > 0) & best_ok
        out.append((ia, ib, best_t, active, owner))
    return out


# --- the step ---------------------------------------------------------------

class Reference:
    """The reference of one configuration on one scene.  ``params`` are the
    driver parameters of the leg; with ``smooth`` off the parameters ``u``
    are the welded vertices and ``M`` is None."""

    def __init__(self, scene, params, device, lowp=False, fault=None):
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.fault = fault
        self.smooth = bool(params.get("smooth", True))
        self.dev = torch.device(device)
        self.p = params
        self.lowp = lowp
        dev = self.dev
        v_src = np.asarray(scene["mesh-source"]["vertices"], np.float32)
        f_src = np.asarray(scene["mesh-source"]["faces"], np.int64)
        self.v_unique, f_unique, self.dup = weld(v_src, f_src)
        V = len(self.v_unique)
        r, c, vals = laplacian(V, f_unique)
        self.M = None
        if self.smooth:
            lam, alpha = params.get("lambda", 1.0), params.get("alpha")
            d = np.arange(V)
            if alpha is None:
                mv = np.concatenate([lam * vals, np.ones(V)])
            else:
                mv = np.concatenate([alpha * vals, np.full(V, 1.0 - alpha)])
            self.M = SPD(np.concatenate([r, d]), np.concatenate([c, d]), mv,
                         V, dev)
        self.L = SPD(r, c, vals, V, dev)
        self.f_unique = torch.as_tensor(f_unique, device=dev)
        self.dup_t = torch.as_tensor(self.dup, device=dev)
        self.faces = torch.as_tensor(f_src, device=dev)
        self.opp = torch.as_tensor(face_adjacency(f_src), device=dev)
        self.res = (int(scene["res_y"]), int(scene["res_x"]))
        self.mvps = torch.as_tensor(mvps(scene), device=dev)
        env = scene.get("envmap_scale", 1.0) * np.asarray(scene["envmap"],
                                                          np.float32)
        self.sh = sh_matrices(env).to(dev)
        self.bgs = backgrounds(env, scene["view_mats"], scene["fov"],
                               self.res).to(dev)
        self.boost = float(params.get("boost", 1.0))
        vt = np.asarray(scene["mesh-target"]["vertices"], np.float32)
        ft = torch.as_tensor(np.asarray(scene["mesh-target"]["faces"],
                                        np.int64), device=dev)
        with torch.no_grad():
            vt_t = torch.as_tensor(vt, device=dev)
            self.ref_imgs = self.render(vt_t, vertex_normals(vt_t, ft), ft,
                                        torch.as_tensor(face_adjacency(
                                            ft.cpu().numpy()), device=dev))

    def u0(self) -> torch.Tensor:
        """u of the source mesh: M v (float64, rounded to float32), or on a
        coordinate leg the welded vertices in float32."""
        v = torch.as_tensor(self.v_unique, dtype=torch.float64,
                            device=self.dev)
        return self.M.mv(v).float() if self.smooth else v.float()

    def render(self, v, n, faces, opp, lowp=None):
        """Images (C, H, W, 4) of vertices v (V, 3) with normals n."""
        lowp = self.lowp if lowp is None else lowp
        H, W = self.res
        clip = _lp(project(v, self.mvps), lowp)
        C = clip.shape[0]
        ids, zb, _ = zbuffer(clip.detach(), faces, self.res)
        hit = (ids > 0).reshape(C, -1)
        t = torch.clamp(ids - 1, min=0).reshape(C, -1)
        cam = torch.arange(C, device=self.dev)[:, None]
        fidx = faces[t]                                   # (C, P, 3)
        pl = planes(clip[cam[..., None], fidx])           # (C, P, 12)
        xs, ys = _grid(W, self.dev), _grid(H, self.dev)
        q0, q1, s, _, _ = at(pl, xs.repeat(H)[None],
                             ys.repeat_interleave(W)[None])
        inv_s = 1.0 / torch.where(s == 0.0, 1.0, s)
        u = torch.where(hit, q0 * inv_s, 0.0)[..., None]
        vv = torch.where(hit, q1 * inv_s, 0.0)[..., None]
        attr = _lp(sh_eval(self.sh, n) / np.pi, lowp)
        a = attr[fidx]                                    # (C, P, 3, 3)
        light = (u * (a[..., 0, :] - a[..., 2, :])
                 + vv * (a[..., 1, :] - a[..., 2, :])) + a[..., 2, :]
        col = torch.cat([light, torch.ones_like(light[..., :1])], -1)
        col = torch.where(hit[..., None], col, self.bgs.reshape(C, -1, 4))
        col = _lp(col, lowp)
        delta = torch.zeros_like(col)
        for ia, ib, t_, act, _ in _pairs(ids, zb, clip, faces, opp,
                                         self.res, self.boost):
            ca, cb = col[:, ia], col[:, ib]
            diff = cb - ca
            td = t_.detach()
            wa = torch.where(td < 0.5, 0.5 - t_, 0.0)
            wb = torch.where(td >= 0.5, t_ - 0.5, 0.0)
            dA = torch.where(act[..., None], wa[..., None] * diff, 0.0)
            dB = torch.where(act[..., None], -wb[..., None] * diff, 0.0)
            delta = delta.index_add(1, ia, dA).index_add(1, ib, dB)
        return _lp((col + delta).reshape(C, H, W, 4), lowp)

    def solve(self, u, lowp=None):
        """v of parameters u: M⁻¹u, or u itself on a coordinate leg; either
        is a stage's hand-off, rounded under ``lowp``."""
        lowp = self.lowp if lowp is None else lowp
        return _lp(Solve.apply(u, self.M) if self.smooth else u, lowp)

    def loss(self, u, tr):
        """(image loss, total loss, logged bilaplacian) at parameters u
        (V', 3) and tr (1, 3)."""
        v = self.solve(u)
        n = _lp(vertex_normals(v, self.f_unique), self.lowp)[self.dup_t]
        v_r = tr + v[self.dup_t]
        imgs = self.render(v_r, n, self.faces, self.opp)
        ref = self.ref_imgs
        if self.fault == "roll_row":
            imgs = torch.roll(imgs, 1, dims=1)
        if self.fault == "half_views":         # the mean over the rest
            half = max(1, imgs.shape[0] // 2)
            imgs, ref = imgs[:half], ref[:half]
        diff = imgs - ref
        err = diff.abs() if self.p.get("loss", "l2") == "l1" \
            else diff.square()
        im = err.mean()
        Lv = _SpMV.apply(v, self.L)
        reg = Lv.square().mean() if self.p.get("bilaplacian", True) \
            else (v * Lv).mean()
        return im, im + float(self.p.get("reg", 0.0)) * reg, \
            Lv.detach().square().mean()

    def grads(self, u, tr):
        """(image loss, gradient of u, gradient of tr) at (u, tr)."""
        u = u.detach().clone().requires_grad_(True)
        tr = tr.detach().clone().requires_grad_(True)
        im, total, _ = self.loss(u, tr)
        gu, gt = torch.autograd.grad(total, (u, tr))
        if not self.p.get("use_tr", True):
            gt = torch.zeros_like(gt)
        return float(im.detach()), gu, gt

    def follow(self, steps, freeze=False, keep=None):
        """``steps`` optimizer steps from the source mesh: the image loss
        of each, the first gradients {leaf: tensor}, the parameters before
        the first, and {step: parameters} after the last (and after step
        ``keep``).  ``freeze`` leaves the state unchanged (a planted
        fault)."""
        u = self.u0()
        tr = torch.zeros((1, 3), dtype=torch.float32, device=self.dev)
        theta = {"tr": tr, "u": u}
        start = {k: x.clone() for k, x in theta.items()}
        opt = Optimizer(self.p.get("optimizer", "AdamUniform"),
                        float(self.p["step_size"]))
        losses, first, after = [], None, {}
        for i in range(steps):
            im, gu, gt = self.grads(theta["u"], theta["tr"])
            losses.append(im)
            g = {"tr": gt, "u": gu}
            if first is None:
                first = g
            if not freeze:
                theta = opt.step(theta, g)
            if i + 1 in (keep, steps):
                after[i + 1] = theta
        return losses, first, start, after


class Optimizer:
    """AdamUniform (``eps + sqrt(max m̂2)`` a leaf) or Adam, float32 bias
    corrections."""

    def __init__(self, kind, lr, b1=0.9, b2=0.999, eps=1e-8):
        if kind not in ("AdamUniform", "Adam"):
            raise ValueError(f"optimizer {kind!r}")
        self.kind, self.lr, self.b, self.eps = kind, lr, (b1, b2), eps
        self.m, self.count = {}, 0

    def step(self, theta, g):
        self.count += 1
        b1, b2 = self.b
        n = torch.tensor(float(self.count), dtype=torch.float32)
        c1, c2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** n)
                  for b in (b1, b2))
        out = {}
        for k, x in theta.items():
            m1, m2 = self.m.get(k, (torch.zeros_like(x), torch.zeros_like(x)))
            m1 = m1 * b1 + (1 - b1) * g[k]
            m2 = m2 * b2 + (1 - b2) * g[k] * g[k]
            self.m[k] = (m1, m2)
            h1, h2 = m1 / c1, m2 / c2
            if self.kind == "AdamUniform":
                upd = -self.lr * h1 / (self.eps + torch.sqrt(torch.max(h2)))
            else:
                upd = h1 / (torch.sqrt(h2) + self.eps) * -self.lr
            out[k] = x + upd
        return out


# --- work of the tile kernels -----------------------------------------------

@torch.no_grad()
def count_clip(clip, faces, res) -> dict:
    """The work of rendering clip positions (C, V, 4) of faces (F, 3) at
    ``res`` and of its backward, for any implementation: the z-tests (pixel
    centres inside each face's screen box, every view), the covered
    pixels, the pairs of neighbouring pixels whose faces differ (one of the
    two owns the pair), and the sizes of inputs and outputs."""
    ids, _, tests = zbuffer(clip, faces, res)
    C, H, W = ids.shape
    pairs = int((ids[:, :, 1:] != ids[:, :, :-1]).sum()
                + (ids[:, 1:] != ids[:, :-1]).sum())
    return {"views": C, "pixels": C * H * W, "verts": int(clip.shape[1]),
            "faces": int(faces.shape[0]), "channels": 4,
            "z_tests": float(tests.sum()), "covered": int((ids > 0).sum()),
            "pairs": pairs}


@torch.no_grad()
def count_work(ref: Reference, u, tr) -> dict:
    """:func:`count_clip` of the vertices of parameters (u, tr)."""
    v = ref.solve(u, lowp=False)[ref.dup_t] + tr
    return count_clip(project(v, ref.mvps), ref.faces, ref.res)


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over rows (vertices) of ‖a_i − b_i‖ over the median
    over rows of ‖b_i‖: the gap of the typical vertex, which a few rows
    far apart do not move."""
    d = torch.linalg.vector_norm((prog - ref).double(), dim=-1)
    b = torch.linalg.vector_norm(ref.double(), dim=-1)
    gap = float(d.median()) / max(float(b.median()), 1e-300)
    return gap if math.isfinite(gap) else float("inf")


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's |‖a‖ − ‖b‖| over max(‖b‖ of that leaf, the median
    leaf's ‖b‖)."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in ref}
    med = statistics.median(norms.values())
    gap = 0.0
    for k in ref:
        if k in skip:
            continue
        a = float(torch.linalg.vector_norm(prog[k].double()))
        gap = max(gap, abs(a - norms[k]) / max(norms[k], med, 1e-300))
    return gap if math.isfinite(gap) else float("inf")
