"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests import neither jax nor largesteps_tpu, so they run on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  Without
a card they skip: the kernels have no CPU mode.

Inputs: icosphere-4 (5,120 faces) in one view, attributes, colours and
cotangents from a numpy seed.

* ``cuda_case`` (all four kernels): 128×128 at the fitted cap (the
  antialias owner tables sit in shared memory) and at cap 9216 (one owner
  table a tile in a global scratch; raster_bwd's sort over more slot
  bits); 256×256 at the fitted cap and at cap 9216, two tiles each
  way, so antialias pairs cross tile borders in both directions and, at cap
  9216, blocks share their neighbours' global tables.
* ``aa_bins`` (the antialias kernels) at 256×256, bins built to stress the
  owner lookup: every face id relabelled so that all collide in the owner
  tables' hash (``aa_home`` in ``csrc/common.cuh``, mirrored below); bins
  that overflow (cap 48, and counts passed above cap); every bin holding
  each face twice (the lowest slot must win).
* ``raster_bins`` (the raster kernels) at 256×256: large triangles
  (icosphere-1 close to the camera: a slot owns thousands of pixels, the
  most contention on one slot's sums, and edges that span the image for
  the corner cull), at the fitted cap and at cap 9216; the overflowing
  bins; every bin holding each face twice, at both caps.

* ``test_gpu_kernels_past_2_31``: all four kernels on 13 views of 256² at
  cap 327,680 (one bin could hold every face of nefertiti), so the records
  of the last tile start past element 2³¹; the live slots are those of the
  fitted cap, and the outputs must equal the plain versions' there.
* The large-F path: device bins on the card equal the CPU's; a banded
  solve on the card against a float64 CPU solve; the batched and the
  camera-sequential prebinned pipes on the card against the same pipes on
  the CPU.
* The banded tier's sweep kernel (``core/banded.py:banded_sweep``) at
  blocks of 128, 768 and 2,048 rows, 1, 2 and 5 blocks, 1 and 3 columns,
  and at nefertiti's matrix (768 × 214): the bits of its plain mirror, the
  plain loop within 1e-5, the float64 residual at most 2e-6, two launches
  the same bits, the launches counted, arguments it does not take
  refused.
* The prebinned pipe's backward glue kernel
  (``render/kernels.py:chain_face_rows``): the bits of
  ``slot_face_rows(chain_planes(...))`` on the card at 1 and 2 cameras
  (faces straddling the halves, sentinels inside their runs, row F, inf
  and NaN columns, −0.0 sums, a zero ``dslot_aa``), two launches the same
  bits, one launch a backward of a prebinned pipe given the face→slot
  inverse (one a camera in the camera-sequential pipe, none in the
  unbinned or an ablated one), and the inputs it refuses.
* The micro-benchmarks' kernels: ``onehot_scatter`` with P not a multiple
  of 4,096, ids out of range (−1, n_faces, far past it) and 18 and 32
  channels; at 1, 3, 18, 32 and 33 channels (scalar, v2 and v4
  reductions) into a small output and a large one, rows of more than 64
  channels cut into windows, and ``scatter_via_faces``' layout (ascending
  live faces, then the camera's sentinel row); ``probe_tile`` at cap 256 and 768, 1 and 208 tiles, on
  random slots, on slots all −1 and on slots all equal (every pixel of a
  tile on one slot), and on slot values that name no column (fractions,
  −0.0, cap itself); at cap 768 on 1, 133 and 208 tiles, random slots
  and runs, through the wrapper and as separate launches of its sums and
  field items; both wrappers refusing inputs that do not start on 16
  bytes.
* The dense renderer on the card against the same render on the CPU.
* Row shards: the four kernels on 2 and 4 row shards of a 256² view (at
  the fitted cap and at 9216), with their tile-row offset and halo rows,
  against their plain versions and, reassembled, the unsharded kernels;
  two gloo ranks sharing the card render one row shard each, against the
  unsharded render.
* Remeshing: the driver with a remesh before the first step (``smooth``
  off, so both remesh the source mesh itself) on the card against the same
  run on the CPU, through the tile kernels; the host Cholesky solver on
  CUDA tensors against the dense inverse.
* The iterative solvers: CG, a V-cycle, AMG-PCG, the dense-block matvec
  and the block-AMG solve at icosphere-4 and -5, and the cotangent
  Laplacian with its gradient, on the card against the CPU.
* ``to_differential`` on the card: the host's sum, the same bits every
  call.
* The fixed-order sums: raster_bwd and aa_bwd launched twice on the same
  inputs, and two 5-step runs of the main path, the same bits.
* ``vis.render_panel`` (tiles at 128², dense at 96²) with the wireframe
  and a highlight, and ``render_core``'s forward and gradient, on the card
  against the CPU.
* The step's CUDA graph (``driver/optimize_shape.py:_StepGraph``): 30
  steps of the viewpoints experiment's bunny leg at 49 views of 256² the
  same bits graphed and eager (losses, final vertices, the optimizer's
  moments); the graphed call's peak memory (``max_memory_allocated``,
  after a warm-up call, as the benchmark reads it) at most 1 % above the
  eager call's; a remesh frees the old graph with its epoch (allocated
  memory lower after) and captures again.
* The span recorder under ``torch.profiler``: each step span's host start
  within 100 µs of its range in the Chrome trace, and its stream interval
  (CUDA events) around the device work launched inside it within 50 µs.

Tolerances: face and slot ids exact, the other forward planes and d_colour
1e-6 absolute (the library is built with ``-fmad=false`` and repeats the
plain version's operations in order); per-slot sums 1e-5 × max|sum| (the
kernels add in another order than ``index_add_``, and so do
onehot_scatter's and probe_tile's sums); probe_tile's fields exact; bins exact; the glue kernel exact; the banded solve
1e-5 relative; pipe and dense images 1e-5 absolute and gradients 1e-4 ×
max|g| (the projection and the glue run as PyTorch's CUDA kernels); the
remeshed run's topology exact and its losses 1e-4 relative; the host
solver 1e-5 × max|x| (a float64 factor against a float32 inverse); the
iterative solves 1e-5 absolute (their tolerances bound the error there),
the V-cycle, the dense-block matvec and the cotangent Laplacian 1e-5 × the
largest entry.
"""
import gc
import importlib

import numpy as np
import pytest
import torch

from largesteps_torch.io.synth import make_scene
from largesteps_torch.render import kernels as K
from largesteps_torch.render.antialias import face_adjacency
from largesteps_torch.render.camera import project
from largesteps_torch.render.pipeline import (RenderPipeline,
                                              RenderPipelineBig,
                                              bin_triangles_device,
                                              bin_triangles_host,
                                              check_bin_overflow,
                                              setup_and_bin, suggest_cap)
from largesteps_torch.render.renderer import Renderer

HASH_BITS = 11        # the widest owner table of these cases (n <= 1024)


def _aa_home(ids, bits):
    """Home slot of face ids in an owner table of 2**bits entries
    (``csrc/common.cuh:aa_home``: Fibonacci hashing of the float's bits)."""
    key = np.asarray(ids, np.float32).view(np.uint32).astype(np.uint64)
    return ((key * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)) \
        >> np.uint64(32 - bits)


def _colliding_ids(count):
    """``count`` float-exact integers that all hash to home 0 in every owner
    table of up to 2**HASH_BITS entries."""
    cand = np.arange(1, 1 << 24, dtype=np.float32)
    ids = cand[_aa_home(cand, HASH_BITS) == 0]
    assert ids.size >= count
    return ids[:count]


def _build(res, cap_rule, level=4, distance=3.5):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene = make_scene(source=("icosphere", level), target=("gourd", 2),
                       n_views=1, res=res, distance=distance)
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64), device=dev)
    opp = torch.as_tensor(face_adjacency(f).astype(np.int64), device=dev)
    mvps = Renderer(scene, device=dev).mvps
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"],
                                    device=dev), mvps)
    occ = check_bin_overflow(v_ndc, faces, (res, res))
    cap = suggest_cap(occ) if cap_rule == "fit" else cap_rule
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    attrs = as_t(rng.normal(size=(v_ndc.shape[1], 3)))
    rfb, rbb, bins, counts = setup_and_bin(v_ndc, faces, attrs, opp, res,
                                           res, cap)
    fwd = [p.contiguous() for p in K.raster_fwd_plain(rfb, counts,
                                                      (res, res))]
    fid = fwd[3]
    cov = (fid > 0)[..., None]
    col4 = torch.where(cov, torch.cat([torch.stack(fwd[5:8], -1),
                                       cov.float()], -1),
                       as_t(rng.uniform(size=(1, res, res, 4))))
    return {"res": (res, res), "occ": occ, "cap": cap, "rfb": rfb,
            "rbb": rbb, "counts": counts, "fwd": fwd,
            "col4": col4.contiguous(),
            "d_out": as_t(rng.normal(size=(1, res, res, 4))),
            "d_col": as_t(rng.normal(size=(1, res, res, 3))),
            "d_u": as_t(rng.normal(size=(1, res, res))),
            "d_v": as_t(rng.normal(size=(1, res, res)))}


@pytest.fixture(params=[(128, "fit"), (128, 9216), (256, "fit"),
                        (256, 9216)],
                ids=["fit", "9216", "256", "256_9216"])
def cuda_case(request):
    return _build(*request.param)


def _overflowing():
    c = _build(256, 48)
    assert c["occ"] > 48
    c["counts"] = (c["counts"] + 50).contiguous()        # above cap as well
    return c


def _duplicated(c):
    """Each tile's live slots, then the same faces again, in both records."""
    counts = c["counts"]
    n = int(counts.max())
    idx = torch.arange(2 * n, device=counts.device)
    cnt = counts[..., None].long()
    src = torch.where(idx < cnt, idx, idx - cnt).clamp(max=n - 1)
    for k in ("rfb", "rbb"):
        r = torch.gather(c[k][..., :n, :], 3,
                         src[..., None].expand(*src.shape, 32))
        c[k] = torch.where((idx < 2 * cnt)[..., None], r, 0.0).contiguous()
    c["counts"] = (2 * counts).contiguous()
    return c


@pytest.fixture(params=["collide", "overflow", "duplicate"])
def aa_bins(request):
    if request.param == "overflow":
        return _overflowing()
    c = _build(256, "fit")
    if request.param == "duplicate":
        return _duplicated(c)
    rbb, counts = c["rbb"], c["counts"]
    assert 2 * int(counts.max()) <= 2 ** HASH_BITS
    n_faces = int(rbb[..., 22].max())
    table = torch.zeros(n_faces + 1, device=rbb.device)
    table[1:] = torch.as_tensor(_colliding_ids(n_faces), device=rbb.device)
    relabel = lambda a: table[a.long()]                  # 0 stays 0
    rbb = rbb.clone()
    for k in (22, 23, 24, 25):                           # fid and opp ids
        rbb[..., k] = relabel(rbb[..., k])
    c["fwd"][3] = relabel(c["fwd"][3]).contiguous()
    c["rbb"] = rbb.contiguous()
    return c


@pytest.fixture(params=[("large", "fit"), ("large", 9216), ("overflow", 48),
                        ("duplicate", "fit"), ("duplicate", 9216)],
                ids=["large", "large_9216", "overflow", "duplicate",
                     "duplicate_9216"])
def raster_bins(request):
    kind, cap = request.param
    if kind == "overflow":
        return _overflowing()
    if kind == "large":
        c = _build(256, cap, level=1, distance=1.6)
        slots = c["fwd"][4]
        most = torch.unique(slots[slots >= 0], return_counts=True)[1].max()
        assert int(most) > 2000                  # one slot, many pixels
        return c
    return _duplicated(_build(256, cap))


def _max_abs(a, b):
    return float((a - b).abs().max())


def _check_raster_fwd(c):
    n0 = K.LAUNCHES["raster_fwd"]
    got = K.raster_fwd(c["rfb"], c["counts"], c["res"])
    torch.cuda.synchronize()
    assert K.LAUNCHES["raster_fwd"] == n0 + 1
    want = [p.contiguous() for p in K.raster_fwd_plain(c["rfb"], c["counts"],
                                                       c["res"])]
    assert int((want[3] > 0).sum()) > 1000       # a real image
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for a, b in zip(got, want):
        assert _max_abs(a, b) < 1e-6
    return want


@pytest.mark.gpu
def test_gpu_raster_fwd(cuda_case):
    assert int(cuda_case["counts"].max()) > 256  # several cull chunks
    _check_raster_fwd(cuda_case)


@pytest.mark.gpu
def test_gpu_raster_fwd_bins(raster_bins):
    want = _check_raster_fwd(raster_bins)
    # the forward planes the bins were built from: a repeated face never
    # wins over its first slot, and an overflowing bin's counts change
    # nothing past the cap
    assert torch.equal(want[4], raster_bins["fwd"][4])


def _check_aa_fwd(c, D):
    fid, z = c["fwd"][3], c["fwd"][2]
    col = c["col4"][..., :D].contiguous()
    n0 = K.LAUNCHES["aa_fwd"]
    got = K.aa_fwd(c["rbb"], c["counts"], fid, z, col, c["res"])
    torch.cuda.synchronize()
    assert K.LAUNCHES["aa_fwd"] == n0 + 1
    want = K.aa_fwd_plain(c["rbb"], c["counts"], fid, z, col, c["res"])
    assert _max_abs(want, col) > 1e-2            # pairs blend
    assert _max_abs(got, want) < 1e-6


def _check_aa_bwd(c, D):
    args = (c["rbb"], c["counts"], c["fwd"][3], c["fwd"][2],
            c["col4"][..., :D].contiguous(),
            c["d_out"][..., :D].contiguous(), c["res"])
    n0 = K.LAUNCHES["aa_bwd"]
    dc, ds = K.aa_bwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aa_bwd"] == n0 + 1
    dcw, dsw = K.aa_bwd_plain(*args)
    assert float(dsw.abs().max()) > 0.0
    assert _max_abs(dc, dcw) < 1e-6
    assert _max_abs(ds, dsw) < 1e-5 * float(dsw.abs().max())
    assert bool((ds[..., 6:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_aa_fwd(cuda_case, D):
    _check_aa_fwd(cuda_case, D)


def _check_raster_bwd(c, slot):
    args = (c["rbb"], c["counts"], slot, c["d_col"], c["d_u"], c["d_v"],
            c["res"])
    n0 = K.LAUNCHES["raster_bwd"]
    got = K.raster_bwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["raster_bwd"] == n0 + 1
    want = K.raster_bwd_plain(*args)
    assert float(want.abs().max()) > 0.0
    assert _max_abs(got, want) < 1e-5 * float(want.abs().max())
    assert bool((got[..., 18:] == 0).all())


@pytest.mark.gpu
def test_gpu_raster_bwd(cuda_case):
    _check_raster_bwd(cuda_case, cuda_case["fwd"][4])


@pytest.mark.gpu
def test_gpu_raster_bwd_bins(raster_bins):
    _check_raster_bwd(raster_bins, raster_bins["fwd"][4])


@pytest.mark.gpu
def test_gpu_raster_bwd_one_slot_a_tile(cuda_case):
    """Every covered pixel of a tile names the tile's slot 0: all lanes of
    every row add into one slot."""
    slot = cuda_case["fwd"][4]
    _check_raster_bwd(cuda_case, torch.where(slot >= 0, 0.0, -1.0))


@pytest.mark.gpu
def test_gpu_raster_bwd_writes_every_element(cuda_case):
    """The output is not zeroed by the wrapper: a freed block of NaNs of
    its size, which the allocator hands out again, must not show through."""
    c = cuda_case
    junk = torch.full(c["rbb"].shape, float("nan"), device="cuda")
    del junk
    got = K.raster_bwd(c["rbb"], c["counts"], c["fwd"][4], c["d_col"],
                       c["d_u"], c["d_v"], c["res"])
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_aa_bwd(cuda_case, D):
    _check_aa_bwd(cuda_case, D)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])
def test_gpu_aa_fwd_bins(aa_bins, D):
    _check_aa_fwd(aa_bins, D)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])
def test_gpu_aa_bwd_bins(aa_bins, D):
    _check_aa_bwd(aa_bins, D)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles,cap,table", [
    (208, 768, 0), (208, 2048, 0),            # three tables fit 96 KB
    (208, 2049, 2 ** 13 * 8), (208, 9216, 2 ** 15 * 8),
    (832, 8192, 2 ** 14 * 8)])                # 13 views at 512²
def test_gpu_aa_scratch_is_one_table_a_tile(tiles, cap, table):
    """Past shared memory, the owner tables take one table of the cap and
    one 8-byte flag a tile, whatever the number of strips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    want = tiles * (table + 8) if table else 0
    assert K._aa_scratch_bytes(tiles, cap) == want


def test_colliding_ids_share_a_home():
    """The relabelling of the ``collide`` case does what it says (CPU)."""
    ids = _colliding_ids(5120)
    assert np.unique(ids).size == ids.size and np.all(ids == np.round(ids))
    for bits in range(5, HASH_BITS + 1):
        assert np.all(_aa_home(ids, bits) == 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_kernels_past_2_31():
    """Each record, slot and sum offset is 64-bit: at cap 327,680 the last
    of 208 tiles starts at element 207 × 327,680 × 32 > 2³¹ of the records
    and of raster_bwd's output."""
    dev = _card()
    c = _build_views(13, 256)
    cap = c["cap"]
    big_cap = 327_680
    assert 207 * big_cap * 32 > 2 ** 31
    C, TY, TX = c["counts"].shape
    assert C * TY * TX == 208
    big = {}
    for k in ("rfb", "rbb"):
        t = torch.zeros((C, TY, TX, big_cap, 32), device=dev)
        t[..., :cap, :] = c[k]
        big[k] = t
    fid, z, slot = c["fwd"][3], c["fwd"][2], c["fwd"][4]
    res, counts = c["res"], c["counts"]
    got = K.raster_fwd(big["rfb"], counts, res)
    for a, b in zip(got, c["fwd"]):
        assert _max_abs(a, b) < 1e-6
    assert torch.equal(got[3], fid) and torch.equal(got[4], slot)
    del got, big["rfb"]
    col = c["col4"]
    assert _max_abs(K.aa_fwd(big["rbb"], counts, fid, z, col, res),
                    K.aa_fwd_plain(c["rbb"], counts, fid, z, col, res)) < 1e-6
    args = (slot, c["d_col"], c["d_u"], c["d_v"], res)
    sums = K.raster_bwd(big["rbb"], counts, *args)
    want = K.raster_bwd_plain(c["rbb"], counts, *args)
    assert _max_abs(sums[..., :cap, :], want) < 1e-5 * float(
        want.abs().max())
    assert not bool(sums[..., cap:, :].any())
    del sums
    dc, ds = K.aa_bwd(big["rbb"], counts, fid, z, col, c["d_out"], res)
    dcw, dsw = K.aa_bwd_plain(c["rbb"], counts, fid, z, col, c["d_out"], res)
    assert _max_abs(dc, dcw) < 1e-6
    assert _max_abs(ds[..., :cap, :], dsw) < 1e-5 * float(dsw.abs().max())
    assert not bool(ds[..., cap:, :].any())


def _build_views(n_views, res, level=4):
    """``_build`` at ``n_views`` views: bins of the fitted cap, the forward
    planes and seeded colours and cotangents, on the card."""
    dev = _card()
    scene = make_scene(source=("icosphere", level), target=("gourd", 2),
                       n_views=n_views, res=res)
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64), device=dev)
    opp = torch.as_tensor(face_adjacency(f).astype(np.int64), device=dev)
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"],
                                    device=dev), Renderer(scene, device=dev).mvps)
    cap = suggest_cap(check_bin_overflow(v_ndc, faces, (res, res)))
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    attrs = as_t(rng.normal(size=(v_ndc.shape[1], 3)))
    rfb, rbb, _, counts = setup_and_bin(v_ndc, faces, attrs, opp, res, res,
                                        cap)
    fwd = [p.contiguous() for p in K.raster_fwd_plain(rfb, counts,
                                                      (res, res))]
    cov = (fwd[3] > 0)[..., None]
    col4 = torch.where(cov, torch.cat([torch.stack(fwd[5:8], -1),
                                       cov.float()], -1),
                       as_t(rng.uniform(size=(n_views, res, res, 4))))
    shape = (n_views, res, res)
    return {"res": (res, res), "cap": cap, "rfb": rfb, "rbb": rbb,
            "counts": counts, "fwd": fwd, "col4": col4.contiguous(),
            "d_out": as_t(rng.normal(size=(*shape, 4))),
            "d_col": as_t(rng.normal(size=(*shape, 3))),
            "d_u": as_t(rng.normal(size=shape)),
            "d_v": as_t(rng.normal(size=shape))}


def _large_f_case(n_views=13, level=5, res=256):
    scene = make_scene(source=("icosphere", level), target=("gourd", 2),
                       n_views=n_views, res=res)
    f = scene["mesh-source"]["faces"]
    r = Renderer(scene, device="cpu")
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"]),
                    r.mvps)
    _, _, occ = bin_triangles_host(v_ndc.numpy(), f, (res, res), margin=4.0)
    return scene, f, v_ndc, suggest_cap(occ)


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [False, True])
def test_gpu_device_bins_match_cpu(cull):
    dev = _card()
    _, f, v_ndc, cap = _large_f_case()
    faces = torch.as_tensor(f.astype(np.int64))
    want = bin_triangles_device(v_ndc, faces, (256, 256), cap, margin=4.0,
                                cull=cull)
    got = bin_triangles_device(v_ndc.to(dev), faces.to(dev), (256, 256),
                               cap, margin=4.0, cull=cull)
    assert int(want[1].max()) > 100
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_gpu_banded_solve():
    """icosphere-5 (10,242 verts) through the banded tier on the card
    against scipy's float64 solve."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.solvers import CholeskySolver
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(5)
    M = compute_matrix(v.astype(np.float32), f, lambda_=19.0, device=dev)
    slv = CholeskySolver(M, dense_limit=100)
    assert slv.tier == "banded"
    b = np.random.default_rng(0).normal(size=(len(v), 3)).astype(np.float32)
    x = slv.solve(torch.as_tensor(b, device=dev)).cpu().numpy()
    st = M.structure
    A = sp.coo_matrix((M.vals.double().cpu().numpy(), (st.rows, st.cols)),
                      shape=st.shape).tocsc()
    x64 = spl.spsolve(A, b.astype(np.float64))
    assert np.abs(x - x64).max() / np.abs(x64).max() < 1e-5


def _sweep_system(B, nb, k, n, seed, dev):
    """A random SPD block-tridiagonal system of nb blocks of B on the card,
    factored by the banded tier's ``_factorize``; a permutation of n rows
    and a right-hand side (n, k) from a numpy seed."""
    from largesteps_torch.core.banded import _factorize
    from largesteps_torch.core.solvers import full_fp32
    rng = np.random.default_rng(seed)
    up = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    A = up(rng.normal(size=(nb, B, B))) * (0.5 / np.sqrt(B))
    D = A @ A.mT + torch.eye(B, device=dev)
    E = up(rng.normal(size=(nb, B, B))) * (0.1 / np.sqrt(B))
    E[0] = 0.0
    with full_fp32():
        invDp, L = _factorize(D, E)
    perm = torch.as_tensor(rng.permutation(n), device=dev)
    return invDp, L, perm, up(rng.normal(size=(n, k)))


def _sweep_loop(invDp, L, b, perm):
    """The plain loop (``_solve_blocks``) on the card, through perm."""
    from largesteps_torch.core.banded import _solve_blocks
    from largesteps_torch.core.solvers import full_fp32
    nb, B, _ = L.shape
    n, k = b.shape
    bp = torch.zeros((nb * B, k), device=b.device)
    bp[:n] = b[perm]
    with full_fp32():
        x = _solve_blocks(invDp, L, bp.view(nb, B, k)).view(-1, k)[:n]
    out = torch.empty_like(x)
    out[perm] = x
    return out, bp.view(nb, B, k)


def _unpermute(xp, perm):
    n = perm.shape[0]
    out = torch.empty((n, xp.shape[-1]), device=xp.device)
    out[perm] = xp.reshape(-1, xp.shape[-1])[:n]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("nb", [1, 2, 5])
@pytest.mark.parametrize("B", [128, 768, 2048])
def test_gpu_banded_sweep(B, nb, k):
    """The sweep kernel on a random SPD block-tridiagonal factor (rows past
    n padded): the same bits as its plain mirror ``banded_sweep_plain``,
    within 1e-5 × max|x| of the plain loop, and two launches the same
    bits."""
    from largesteps_torch.core.banded import (LAUNCHES, banded_sweep,
                                              banded_sweep_plain)
    dev = _card()
    n = nb * B - (0 if nb == 1 else 37)
    invDp, L, perm, b = _sweep_system(B, nb, k, n, 16 * B + nb + k, dev)
    before = LAUNCHES["banded_sweep"]
    x = banded_sweep(invDp, L, b, perm)
    x2 = banded_sweep(invDp, L, b, perm)
    assert LAUNCHES["banded_sweep"] == before + 2
    want, bp = _sweep_loop(invDp, L, b, perm)
    mirror = _unpermute(banded_sweep_plain(invDp, L, bp), perm)
    torch.cuda.synchronize()
    assert torch.equal(x, x2)
    assert torch.equal(x, mirror)
    assert float((x - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_gpu_banded_sweep_nefertiti():
    """nefertiti's matrix (icosphere-7, α = 0.98: B = 768, nb = 214) through
    the banded tier on the card, one and three columns: one launch a solve,
    two with the adjoint; the relative residual ‖Mx − b‖/‖b‖ in float64 at
    most 2e-6; within 1e-5 × max|x| of the plain loop; no farther from
    scipy's float64 solve than twice the plain loop is (about 2e-5 of
    max|x| at this α: the float32 factor's own error); the mirror's bits;
    two launches the same bits."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    from largesteps_torch.core.banded import (LAUNCHES, BandedSolver,
                                              banded_sweep_plain)
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.solvers import solve
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(7)
    M = compute_matrix(v.astype(np.float32), f, alpha=0.98, device=dev)
    slv = BandedSolver(M)
    assert (slv.B, slv.nb) == (768, 214)
    st = M.structure
    A = sp.coo_matrix((M.vals.double().cpu().numpy(), (st.rows, st.cols)),
                      shape=st.shape).tocsc()
    rng = np.random.default_rng(7)
    for k in (1, 3):
        b = torch.as_tensor(rng.normal(size=(len(v), k)).astype(np.float32),
                            device=dev)
        before = LAUNCHES["banded_sweep"]
        x, x2 = slv.solve(b), slv.solve(b)
        assert LAUNCHES["banded_sweep"] == before + 2
        want, bp = _sweep_loop(slv.invDp, slv.L, b, slv.perm)
        mirror = _unpermute(banded_sweep_plain(slv.invDp, slv.L, bp),
                            slv.perm)
        torch.cuda.synchronize()
        assert torch.equal(x, x2) and torch.equal(x, mirror)
        assert float((x - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        xn, bn = x.double().cpu().numpy(), b.double().cpu().numpy()
        assert np.linalg.norm(A @ xn - bn) <= 2e-6 * np.linalg.norm(bn)
        x64 = spl.spsolve(A, bn).reshape(bn.shape)
        loop_err = np.abs(want.double().cpu().numpy() - x64).max()
        assert np.abs(xn - x64).max() <= 2 * loop_err
    u = b.clone().requires_grad_(True)
    before = LAUNCHES["banded_sweep"]
    solve(slv, u).square().sum().backward()
    assert LAUNCHES["banded_sweep"] == before + 2
    assert torch.isfinite(u.grad).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["block_64", "block_2176", "block_200",
                                 "k_5", "rows", "float64", "strided",
                                 "perm_int32", "unaligned"])
def test_gpu_banded_sweep_rejects(bad):
    """The wrapper raises on what the kernel does not take, and the
    launcher refuses a block out of range by itself."""
    from largesteps_torch import _cuda
    from largesteps_torch.core.banded import LAUNCHES, banded_sweep
    dev = _card()
    args = _sweep_bad_args(bad, dev)
    before = LAUNCHES["banded_sweep"]
    with pytest.raises(ValueError):
        banded_sweep(*args)
    assert LAUNCHES["banded_sweep"] == before
    assert _cuda.launch_shape("banded_sweep", 2176, 3)[0] == 0
    assert _cuda.launch_shape("banded_sweep", 768, 5)[0] == 0
    invDp, L, b, perm = _sweep_bad_args("block_2176", dev)
    scratch = torch.empty(2 * L.shape[0] * 2176 * 3, dtype=torch.int64,
                          device=dev)
    out = torch.empty_like(b)
    assert _cuda.library("banded_sweep")(
        invDp.data_ptr(), L.data_ptr(), b.data_ptr(), perm.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b.shape[0], 2176, 1, 3,
        _cuda.stream(dev)) != 0


def _sweep_bad_args(bad, dev):
    """Arguments of ``banded_sweep`` on ``dev`` with one thing the kernel
    does not take: a block of 64, 2,176 or 200 rows, 5 right-hand columns,
    more rows than the blocks hold, float64, a strided b, an int32 perm, a
    factor that does not start on 16 bytes."""
    nb, k = 2, 3
    B = {"block_64": 64, "block_2176": 2176, "block_200": 200}.get(bad, 128)
    n = nb * B + 1 if bad == "rows" else 200
    invDp = torch.zeros((nb, B, B), device=dev)
    L = torch.zeros(nb * B * B + 1, device=dev)
    L = L[1:] if bad == "unaligned" else L[:-1]
    b = torch.zeros((n, 5 if bad == "k_5" else k), device=dev)
    if bad == "float64":
        b = b.double()
    if bad == "strided":
        b = torch.zeros((k, n), device=dev).mT
    perm = torch.arange(n, device=dev)
    if bad == "perm_int32":
        perm = perm.int()
    return invDp, L.view(nb, B, B), b, perm


@pytest.mark.gpu
@pytest.mark.parametrize("big", [False, True], ids=["batched", "big"])
def test_gpu_prebinned_pipes_match_cpu(big):
    """icosphere-4 in 2 views of 256² through device bins with the
    face→slot inverse: the pipe on the card against the same pipe on the
    CPU (the kernels' plain versions)."""
    dev = _card()
    scene, f, v_ndc, cap = _large_f_case(n_views=2, level=4)
    faces = torch.as_tensor(f.astype(np.int64))
    binned = bin_triangles_device(v_ndc, faces, (256, 256), cap,
                                  margin=4.0)[:3]
    r = Renderer(scene, device="cpu")
    rng = np.random.default_rng(1)
    attrs = torch.as_tensor(rng.uniform(size=(v_ndc.shape[1], 3)).astype(
        np.float32))
    w = torch.as_tensor(rng.normal(size=(2, 256, 256, 4)).astype(np.float32))
    kind = RenderPipelineBig if big else RenderPipeline
    kw = {} if big else {"prebinned": True}
    pipe = kind(f, face_adjacency(f), (256, 256), boost=3.0, cap=cap,
                slots_k=int(binned[2].shape[-1]), **kw)
    out = {}
    for d in ("cpu", dev):
        vc = v_ndc.to(d).clone().requires_grad_(True)
        a = attrs.to(d).clone().requires_grad_(True)
        img = pipe(vc, a, r.bgs.to(d), *(t.to(d) for t in binned))
        (w.to(d) * img).sum().backward()
        out[str(d)] = (img.detach().cpu(), vc.grad.cpu(), a.grad.cpu())
    (ic, gc, ac), (ig, gg, ag) = out["cpu"], out[str(dev)]
    assert float(ic.abs().max()) > 0.1
    assert _max_abs(ig, ic) < 1e-5
    assert _max_abs(gg, gc) < 1e-4 * float(gc.abs().max())
    assert _max_abs(ag, ac) < 1e-4 * float(ac.abs().max())


def _chain_case(n_cams, zero_aa, dev):
    """Per-slot sums, records and a face→slot inverse on ``dev``: 1 camera
    of 128² (4 × 1 tiles, cap 256, 300 faces, K = 4) or 2 of 256² (8 × 2
    tiles, cap 512, 5,000 faces, K = 6).  Each face's slots are distinct
    and in tile order, a third of them sentinels (T·cap) inside the runs;
    row F is all sentinels.  Face 0 straddles the halves, faces 1-2 hold a
    slot with an inf and a NaN column, face 3 a lower slot before an upper
    one, face 4 a slot of −0.0 sums alone.  ``zero_aa`` zeroes dslot_aa."""
    rng = np.random.default_rng(11 + n_cams)
    TY, TX, cap, F, Kn = (4, 1, 256, 300, 4) if n_cams == 1 \
        else (8, 2, 512, 5_000, 6)
    C, S = n_cams, TY * TX * cap
    rand = lambda *shape: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32))
    dslot, rbb = rand(C, TY, TX, cap, 32), rand(C, TY, TX, cap, 32)
    dslot_aa = rand(C, TY, TX, cap, 8)
    if zero_aa:
        dslot_aa.zero_()
    up = TX * cap * (TY // 2)                   # first slot of the lower half
    dslot.view(C, S, 32)[:, 7, 3] = float("inf")
    dslot.view(C, S, 32)[:, 7, 8] = float("nan")
    dslot.view(C, S, 32)[:, 9] = -0.0
    dslot_aa.view(C, S, 8)[:, 9] = -0.0
    fslots = np.full((C, F + 1, Kn), S, np.int64)
    for c in range(C):
        fslots[c, :F] = np.sort(np.stack([rng.choice(S, Kn, replace=False)
                                          for _ in range(F)]), axis=1)
    fslots[:, :F][rng.random((C, F, Kn)) < 1 / 3] = S
    fslots[:, :5] = S
    fslots[:, 0, :3] = [3, S, up + 1]
    fslots[:, 1, :2] = [7, up + 7]
    fslots[:, 2, 1] = 7
    fslots[:, 3, :3] = [up + 2, 4, S]
    fslots[:, 4, 0] = 9
    return (dslot.to(dev), dslot_aa.to(dev), rbb.to(dev),
            torch.as_tensor(fslots).to(dev), TY)


@pytest.mark.gpu
@pytest.mark.parametrize("zero_aa", [False, True], ids=["aa", "zero_aa"])
@pytest.mark.parametrize("n_cams", [1, 2])
def test_gpu_chain_face_rows_is_the_composition(n_cams, zero_aa):
    """The glue kernel gives the bits of ``slot_face_rows(chain_planes(...))``
    run on the card (``_chain_case``), and two launches the same bits."""
    from largesteps_torch.render.pipeline import (chain_planes, first_half,
                                                  slot_face_rows)
    dev = _card()
    dslot, dslot_aa, rbb, fslots, TY = _chain_case(n_cams, zero_aa, dev)
    before = K.LAUNCHES["chain_face_rows"]
    got = K.chain_face_rows(dslot, dslot_aa, 3.0, rbb, fslots, TY // 2)
    again = K.chain_face_rows(dslot, dslot_aa, 3.0, rbb, fslots, TY // 2)
    want = slot_face_rows(chain_planes(dslot, dslot_aa, 3.0, rbb), fslots,
                          first_half(TY, device=dev))
    torch.cuda.synchronize()
    assert K.LAUNCHES["chain_face_rows"] == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[:, :4].abs().amax(dim=2) > 0).all()        # faces 0-3 live
    assert torch.equal(got[:, -1], torch.zeros_like(got[:, -1]))
    assert not torch.signbit(got[:, 4]).any()           # −0.0 sums add to +0


@pytest.mark.gpu
def test_gpu_chain_face_rows_launches_once_a_backward():
    """A backward of the batched prebinned pipe given the face→slot
    inverse launches the glue kernel once, the camera-sequential pipe once
    a camera; the unbinned pipe and an ablated scatter launch it never."""
    dev = _card()
    scene, f, v_ndc, cap = _large_f_case(n_views=2, level=4)
    faces = torch.as_tensor(f.astype(np.int64))
    binned = [t.to(dev) for t in bin_triangles_device(
        v_ndc, faces, (256, 256), cap, margin=4.0)[:3]]
    attrs = torch.rand((v_ndc.shape[1], 3), device=dev)
    bg = Renderer(scene, device="cpu").bgs.to(dev)
    adj, K_ = face_adjacency(f), int(binned[2].shape[-1])
    pipes = {"batched": (RenderPipeline(f, adj, (256, 256), boost=3.0,
                                        cap=cap, prebinned=True, slots_k=K_),
                         binned, 1),
             "camera_sequential": (RenderPipelineBig(
                 f, adj, (256, 256), boost=3.0, cap=cap, slots_k=K_),
                 binned, 2),
             "unbinned": (RenderPipeline(f, adj, (256, 256), boost=3.0,
                                         cap=cap), [], 0),
             "ablated": (RenderPipeline(
                 f, adj, (256, 256), boost=3.0, cap=cap, prebinned=True,
                 slots_k=K_, ablate="scatter"), binned, 0)}
    for name, (pipe, b, want) in pipes.items():
        vc = v_ndc.to(dev).clone().requires_grad_(True)
        img = pipe(vc, attrs, bg, *b)
        before = K.LAUNCHES["chain_face_rows"]
        img.sum().backward()
        torch.cuda.synchronize()
        assert K.LAUNCHES["chain_face_rows"] == before + want, name
        assert torch.isfinite(vc.grad).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["fslots_int32", "strided", "mixed_devices",
                                 "up_rows"])
def test_gpu_chain_face_rows_rejects(bad):
    """The wrapper raises on int32 fslots, a strided dslot, tensors on
    two devices and a split outside the tile rows, and launches nothing."""
    dev = _card()
    dslot, dslot_aa, rbb, fslots, TY = _chain_case(1, False, dev)
    up = TY // 2
    if bad == "fslots_int32":
        fslots = fslots.int()
    elif bad == "strided":
        dslot = torch.cat([dslot, dslot], dim=-1)[..., :32]
    elif bad == "mixed_devices":
        rbb = rbb.cpu()
    else:
        up = TY + 1
    before = K.LAUNCHES["chain_face_rows"]
    with pytest.raises(ValueError):
        K.chain_face_rows(dslot, dslot_aa, 3.0, rbb, fslots, up)
    assert K.LAUNCHES["chain_face_rows"] == before


@pytest.mark.gpu
def test_gpu_host_copy_of_a_step_scalar_does_not_wait():
    """The driver reads a step's displacement through a pinned host copy
    queued behind the step: taking the copy returns while the card is still
    busy, and the copy holds the value once the event after it completes."""
    from largesteps_torch.driver.bins import _queued
    _card()
    t = torch.tensor(3.5, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)              # about half a second of work
    h, event = _queued(t * 2.0)
    assert not event.query()                # the host did not wait
    assert h.device.type == "cpu" and h.is_pinned()
    event.synchronize()
    assert float(h) == 7.0


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [18, 32])
def test_gpu_onehot_scatter(ch):
    """P = 5,000 (not a multiple of 4,096) over 3 cameras, ids from −1 to
    past n_faces: the out-of-range ones add nothing."""
    from largesteps_torch.benchmarks import micro_scatter as ms
    dev = _card()
    rng = np.random.default_rng(ch)
    C, P, F = 3, 5_000, 600
    ids = rng.integers(-1, F + 2, (C, P)).astype(np.int32)
    ids[0, :7] = [-1, F, F + 1, 2 ** 30, -2 ** 31, 0, F - 1]
    m = rng.normal(size=(C, P, ch)).astype(np.float32)
    ids_t, m_t = torch.as_tensor(ids, device=dev), torch.as_tensor(m, device=dev)
    n0 = ms.LAUNCHES["onehot_scatter"]
    got = ms.onehot_scatter(ids_t, m_t, F)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["onehot_scatter"] == n0 + 1
    want = ms.onehot_scatter_plain(ids_t, m_t, F)
    ok = (ids >= 0) & (ids < F)
    ref = np.zeros((F, ch))
    np.add.at(ref, ids[ok], m[ok].astype(np.float64))
    scale = float(np.abs(ref).max())
    assert _max_abs(got, want) < 1e-5 * scale
    assert np.abs(got.cpu().numpy() - ref).max() < 1e-5 * scale


def _scatter_check(ids, m, F):
    """onehot_scatter on the card against its plain version and an
    ``np.add.at`` oracle, both at 1e-5 × max|oracle|; one launch."""
    from largesteps_torch.benchmarks import micro_scatter as ms
    dev = _card()
    ids_t, m_t = torch.as_tensor(ids, device=dev), torch.as_tensor(m, device=dev)
    n0 = ms.LAUNCHES["onehot_scatter"]
    got = ms.onehot_scatter(ids_t, m_t, F)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["onehot_scatter"] == n0 + 1
    want = ms.onehot_scatter_plain(ids_t, m_t, F)
    ok = (ids >= 0) & (ids < F)
    ref = np.zeros((F, m.shape[-1]))
    np.add.at(ref, ids[ok], m[ok].astype(np.float64))
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert _max_abs(got, want) <= 1e-5 * scale
    assert np.abs(got.cpu().numpy() - ref).max() <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [1, 3, 18, 32, 33])
@pytest.mark.parametrize("F", [300, 200_000])
def test_gpu_onehot_scatter_shapes(F, ch):
    """An output of 300 faces, which a block's shared memory could hold, and
    one of 200,000, far past it (both reduce into L2), at channel counts of
    each vector width (1, 3, 33 scalar; 18 two; 32 four); 4 × 50,001
    entries, ids from −1 to past n_faces, runs of equal ids among them (a
    run of 300 on one face, a run of 100 out of range)."""
    rng = np.random.default_rng(ch)
    C, P = 4, 50_001
    ids = rng.integers(-1, F + 2, (C, P)).astype(np.int32)
    ids[1, 100:400] = 7
    ids[2, 1000:1100] = -1
    m = rng.normal(size=(C, P, ch)).astype(np.float32)
    _scatter_check(ids, m, F)


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [100, 130])
def test_gpu_onehot_scatter_windows(ch):
    """Rows of more than 64 channels are cut into windows, one grid row
    each: 100 channels (v4) into 64 and 36, 130 (v2) into 64, 64 and 2."""
    from largesteps_torch import _cuda
    _card()
    rng = np.random.default_rng(ch)
    C, P, F = 2, 20_000, 1_000
    plan = _cuda.launch_shape("onehot_scatter", C * P, ch)
    assert plan[1] == 64 and plan[3] == -(-ch // 64)
    ids = rng.integers(0, F, (C, P)).astype(np.int32)
    m = rng.normal(size=(C, P, ch)).astype(np.float32)
    _scatter_check(ids, m, F)


@pytest.mark.gpu
@pytest.mark.parametrize("C,F", [(2, 20), (13, 5_121)])
def test_gpu_onehot_scatter_sentinel_layout(C, F):
    """``scatter_via_faces``'s layout: 16 tiles of 768 slots a camera, each
    tile's live faces ascending and the rest on the camera's sentinel row
    F, ids offset by c · (F + 1); 18 channels; (13, 5,121) is the main
    path's shape, (2, 20) nearly all sentinels."""
    from largesteps_torch.render.pipeline import face_ids
    rng = np.random.default_rng(C)
    T, cap = 16, 768
    bins = np.full((C, T, cap), -1, np.int64)
    for c in range(C):
        for t in range(T):
            n = int(rng.integers(0, min(cap, F) + 1))
            bins[c, t, :n] = np.sort(rng.choice(F, n, replace=False))
    ids = face_ids(torch.as_tensor(bins), F).numpy().astype(np.int32)
    ids = ids.reshape(1, -1)
    m = rng.normal(size=(1, C * T * cap, 18)).astype(np.float32)
    _scatter_check(ids, m, C * (F + 1))


@pytest.mark.gpu
def test_gpu_micro_kernels_reject_unaligned():
    """Both wrappers read 16 bytes at a time: a contiguous view that does
    not start on 16 bytes raises."""
    from largesteps_torch.benchmarks import micro_scatter as ms
    from largesteps_torch.benchmarks import probe_mosaic as pm
    dev = _card()
    buf = torch.zeros(1 + 32 * 128, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        ms.onehot_scatter(torch.zeros((1, 128), dtype=torch.int32,
                                      device=dev), buf[1:].view(1, 128, 32), 4)
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        pm.probe_tile(buf[1:].view(1, 32, 128), z(1, 32, 256), z(1, 32, 128))


def _probe_slots(kind, B, cap, rng):
    if kind == "random":
        return rng.integers(-1, cap, (B, 32, 128)).astype(np.float32)
    if kind == "all_minus_one":
        return np.full((B, 32, 128), -1.0, np.float32)
    if kind == "all_equal":
        return np.repeat(rng.integers(0, cap, (B, 1, 1)), 32 * 128) \
            .reshape(B, 32, 128).astype(np.float32)
    # values that name no column, among ones that do
    s = rng.integers(-1, cap, (B, 32, 128)).astype(np.float32)
    bad = np.array([0.5, cap, cap + 0.5, -0.5, 1e9, -1e9, np.nan], np.float32)
    s.reshape(B, -1)[:, :bad.size] = bad
    s.reshape(B, -1)[:, bad.size] = -0.0               # names column 0
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("B,cap", [(1, 256), (1, 768), (208, 256),
                                   (208, 768)])
@pytest.mark.parametrize("kind", ["random", "all_minus_one", "all_equal",
                                  "no_column"])
def test_gpu_probe_tile(B, cap, kind):
    from largesteps_torch.benchmarks import probe_mosaic as pm
    dev = _card()
    rng = np.random.default_rng(B + cap)
    slot = _probe_slots(kind, B, cap, rng)
    recT = rng.normal(size=(B, 32, cap)).astype(np.float32)
    g0 = rng.normal(size=(B, 32, 128)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (slot, recT, g0)]
    n0 = pm.LAUNCHES["probe_tile"]
    fields, S = pm.probe_tile(*args)
    torch.cuda.synchronize()
    assert pm.LAUNCHES["probe_tile"] == n0 + 1
    fw, Sw = pm.probe_tile_plain(*args)
    assert torch.equal(fields, fw)
    scale = max(float(Sw.abs().max()), 1e-30)
    assert _max_abs(S, Sw) <= 1e-5 * scale
    if kind == "all_minus_one":
        assert not bool(fields.any()) and not bool(S.any())
    else:
        fo, So = pm.oracle(np.nan_to_num(slot, nan=-1.0), recT, g0)
        assert np.array_equal(fields.cpu().numpy(), fo)
        assert np.abs(S.cpu().numpy() - So).max() <= 1e-5 * scale


def _run_slots(B, rng):
    """Slot planes as the rasterizer leaves them: runs of neighbouring
    pixels on one slot (lengths 1-200 in pixel order), some −1."""
    s = np.empty((B, 32 * 128), np.float32)
    for b in range(B):
        p = 0
        while p < s.shape[1]:
            n = int(rng.integers(1, 201))
            s[b, p:p + n] = rng.integers(-1, 768)
            p += n
    return s.reshape(B, 32, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 133, 208])
@pytest.mark.parametrize("kind", ["random", "runs"])
@pytest.mark.parametrize("launch", ["wrapper", "items"])
def test_gpu_probe_tile_grid(B, kind, launch):
    """The persistent grid at cap 768 over 1 tile, 133 (a wave of tiles and
    one more) and 208 (the main path's), on random slots and on runs:
    through the wrapper, and as two launches of its work items (the B sums
    items, then the 4 B field items, as ``kernel_probe.py`` times them),
    each against the plain version (fields exact, S 1e-5 × max)."""
    from largesteps_torch import _cuda
    from largesteps_torch.benchmarks import probe_mosaic as pm
    dev = _card()
    cap = 768
    rng = np.random.default_rng(B)
    slot = _probe_slots("random", B, cap, rng) if kind == "random" \
        else _run_slots(B, rng)
    recT = rng.normal(size=(B, 32, cap)).astype(np.float32)
    g0 = rng.normal(size=(B, 32, 128)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (slot, recT, g0)]
    if launch == "wrapper":
        fields, S = pm.probe_tile(*args)
    else:
        fields = torch.empty((B, 32, 4096), device=dev)
        S = torch.empty((B, cap, 18), device=dev)
        items = _cuda.library("probe_tile", "ls_probe_tile_items")
        ptrs = [a.data_ptr() for a in (*args, fields, S)]
        stream = torch.cuda.current_stream().cuda_stream
        for first, n in ((0, B), (B, 4 * B)):
            _cuda.check("probe_tile", items(*ptrs, B, cap, first, n, stream))
    torch.cuda.synchronize()
    blocks, threads, smem, per_sm, n_items = _cuda.launch_shape(
        "probe_tile", B, cap)[:5]
    # two buffers of 8 record rows; counts, starts, ranks and buckets
    assert (threads, smem, n_items) == (256, (16 * cap + 2 * cap + 8192) * 4,
                                        5 * B)
    assert blocks == min(5 * B, per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count)
    fw, Sw = pm.probe_tile_plain(*args)
    assert torch.equal(fields, fw)
    assert _max_abs(S, Sw) <= 1e-5 * float(Sw.abs().max())


@pytest.mark.gpu
def test_gpu_probe_tile_cap_past_shared_memory_raises():
    from largesteps_torch.benchmarks import probe_mosaic as pm
    dev = _card()
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        pm.probe_tile(z(1, 32, 128), z(1, 32, 2048), z(1, 32, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("shading", [True, False])
def test_gpu_dense_renderer_matches_cpu(shading):
    """icosphere-3 in 2 views of 72×56 (no tiling), boost 3, through the
    dense renderer on the card and on the CPU."""
    dev = _card()
    scene = make_scene(source=("icosphere", 3), target=("gourd", 2),
                       n_views=2, res=72)
    scene["res_x"] = 56
    f = scene["mesh-source"]["faces"]
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.render.renderer import Topology
    v0 = torch.as_tensor(scene["mesh-source"]["vertices"])
    n0 = compute_vertex_normals(v0, f, compute_face_normals(v0, f))
    w = None
    out = {}
    for d in ("cpu", dev):
        r = Renderer(scene, shading=shading, boost=3, device=d)
        assert r.backend == "dense"
        v = v0.to(d).clone().requires_grad_(True)
        n = n0.to(d).clone().requires_grad_(True)
        img = r.render(v, n, Topology(f))
        if w is None:
            w = torch.as_tensor(np.random.default_rng(2).normal(
                size=tuple(img.shape)).astype(np.float32))
        (w.to(d) * img).sum().backward()
        out[str(d)] = (img.detach().cpu(), v.grad.cpu(),
                       None if n.grad is None else n.grad.cpu())
    (ic, gc, nc), (ig, gg, ng) = out["cpu"], out[str(dev)]
    assert float(ic.abs().max()) > 0.1
    assert _max_abs(ig, ic) < 1e-5
    assert _max_abs(gg, gc) < 1e-4 * float(gc.abs().max())
    if shading:
        assert _max_abs(ng, nc) < 1e-4 * float(nc.abs().max())


@pytest.mark.gpu
def test_gpu_remesh_at_start_matches_cpu():
    """icosphere-2 fitted to gourd-2 in 2 views of 128² (the tile kernels),
    Adam on the coordinates, remeshed before the first step: the same
    topology on the card and on the CPU, and the same losses."""
    from largesteps_torch.driver import optimize_shape
    dev = _card()
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=2, res=128)
    params = {"smooth": False, "optimizer": "Adam", "reg": 0.16,
              "loss": "l1", "alpha": 0.95, "boost": 3, "step_size": 1e-2,
              "steps": 5, "remesh": 0}
    launches = dict(K.LAUNCHES)
    card = optimize_shape(scene, params, device=dev)
    assert all(K.LAUNCHES[k] >= launches[k] + params["steps"]
               for k in K.TILE_KERNELS)
    cpu = optimize_shape(scene, params, device="cpu")
    assert len(card["f"]) == len(cpu["f"]) == 2
    for a, b in zip(card["f"], cpu["f"]):
        np.testing.assert_array_equal(a, b)
    assert len(card["f"][1]) > len(card["f"][0])
    assert np.isfinite(card["losses"]).all()
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-4)


@pytest.mark.gpu
def test_gpu_cholesky_host_solver():
    """icosphere-4 (2,562 verts): the host solver on CUDA tensors against
    the dense inverse on the card, its solve and its gradient."""
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.solvers import (CholeskyHostSolver,
                                               CholeskySolver, solve)
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(4)
    M = compute_matrix(v.astype(np.float32), f, lambda_=19.0, device=dev)
    host, dense = CholeskyHostSolver(M), CholeskySolver(M)
    rng = np.random.default_rng(0)
    b, w = (torch.as_tensor(rng.normal(size=(len(v), 3)).astype(np.float32),
                            device=dev) for _ in range(2))
    out = []
    for slv in (host, dense):
        bb = b.clone().requires_grad_(True)
        x = solve(slv, bb)
        (w * x).sum().backward()
        assert x.device == b.device and x.dtype == torch.float32
        out.append((x.detach(), bb.grad))
    (xh, gh), (xd, gd) = out
    assert _max_abs(xh, xd) < 1e-5 * float(xd.abs().max())
    assert _max_abs(gh, gd) < 1e-5 * float(gd.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("subdiv", [4, 5])
def test_gpu_iterative_solvers_match_cpu(subdiv):
    """icosphere-4 and -5 (2,562 and 10,242 verts), λ = 19, u = M v: CG,
    one V-cycle of a three-level hierarchy, AMG-PCG, the dense-block matvec
    (RCM order, padded) and the block-AMG solve on the card against the same
    on the CPU.  CG's and the PCG solves' x within 1e-5 of the CPU's and 5e-4
    of v; the V-cycle and the matvec 1e-5 × their largest entry (sums in
    another order)."""
    from largesteps_torch.core import multigrid as mg
    from largesteps_torch.core.blocksp import BlockedOperator
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.parameterize import to_differential
    from largesteps_torch.core.solvers import (BlockAmgSolver,
                                               ConjugateGradientSolver)
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(subdiv)
    r = np.random.default_rng(subdiv).normal(size=(len(v), 3)).astype(
        np.float32)
    out = {}
    for d in (torch.device("cpu"), dev):
        M = compute_matrix(v.astype(np.float32), f, lambda_=19.0, device=d)
        u = to_differential(M, torch.as_tensor(v, device=d))
        h = mg.build_hierarchy(M, coarse_limit=subdiv * 40)
        bamg = BlockAmgSolver(M)
        fine = bamg._mg.h.levels[0].op
        xp = torch.zeros((bamg.n_pad, 3), device=d)
        xp[:bamg.n] = torch.as_tensor(r, device=d)[bamg.perm]
        out[d.type] = {
            "cg": ConjugateGradientSolver(M).solve(u),
            "vcycle": mg.vcycle(h, torch.as_tensor(r, device=d)),
            "amg_pcg": mg.amg_pcg_solve(h, u),
            "matvec": fine.matvec(xp),
            "blockamg": bamg.solve(u),
        }
        assert len(h.levels) >= 3
        assert isinstance(fine, BlockedOperator) == (subdiv == 5)
    for k, want in out["cpu"].items():
        got = out["cuda"][k].cpu()
        if k in ("vcycle", "matvec"):
            assert _max_abs(got, want) <= 1e-5 * float(want.abs().max()), k
        else:
            assert _max_abs(got, want) <= 1e-5, k
            assert float((got - torch.as_tensor(v)).abs().max()) < 5e-4, k


@pytest.mark.gpu
def test_gpu_laplacian_cot_matches_cpu():
    """icosphere-4 with seeded radial bumps: the cotangent Laplacian's
    values, ``compute_matrix(cotan=True)``'s and the gradient in the
    vertices of Σ w ⊙ (L_cot v) on the card against the CPU, 1e-5 × the
    largest entry."""
    from largesteps_torch.core.geometry import compute_matrix, laplacian_cot
    from largesteps_torch.core.sparse import coo_matvec
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(4)
    rng = np.random.default_rng(5)
    v = (v * (1.0 + 0.1 * rng.uniform(size=(len(v), 1)))).astype(np.float32)
    w = rng.normal(size=v.shape).astype(np.float32)
    out = {}
    for d in (torch.device("cpu"), dev):
        vt = torch.as_tensor(v, device=d).requires_grad_(True)
        L = laplacian_cot(vt, f)
        M = compute_matrix(vt, f, alpha=0.95, cotan=True)
        (torch.as_tensor(w, device=d) * coo_matvec(L, vt)).sum().backward()
        out[d.type] = (L.vals.detach(), M.vals.detach(), vt.grad)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _max_abs(got.cpu(), want) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# row shards: the kernels' tile-row offset and halo rows, a 2-rank render
# ---------------------------------------------------------------------------

def _shard_args(c, s, sp, D):
    """Row shard s of sp of a case: its tile rows, planes and halo rows
    (the next shard's first rows; its own last on the last shard)."""
    res = c["res"][0]
    tyl, hl = res // 32 // sp, res // sp
    tiles, rows = slice(s * tyl, (s + 1) * tyl), slice(s * hl, (s + 1) * hl)
    nxt = rows.stop - 1 if s == sp - 1 else rows.stop
    T = lambda a, sl: a[:, sl].contiguous()
    col, d_out = c["col4"][..., :D], c["d_out"][..., :D]
    fid, z = c["fwd"][3], c["fwd"][2]
    halo = tuple(a[:, nxt].contiguous() for a in (fid, z, col))
    return {"row0": s * tyl, "rfb": T(c["rfb"], tiles),
            "rbb": T(c["rbb"], tiles), "counts": T(c["counts"], tiles),
            "fid": T(fid, rows), "z": T(z, rows), "col": T(col, rows),
            "d_out": T(d_out, rows), "slot": T(c["fwd"][4], rows),
            "d_col": T(c["d_col"], rows), "d_u": T(c["d_u"], rows),
            "d_v": T(c["d_v"], rows), "halo": halo,
            "halo_b": halo + (d_out[:, nxt].contiguous(),), "rows": rows}


@pytest.mark.gpu
@pytest.mark.parametrize("cap,sp", [("fit", 2), ("fit", 4), (9216, 2)],
                         ids=["sp2", "sp4", "sp2_9216"])
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_kernels_row_shards(cap, sp, D):
    """The four kernels on row shards of a 256² view (a shard with row0 > 0
    and the last one among them), with halo rows, against their plain
    versions on the same shard; the shards, their shares added, give the
    unsharded kernels' planes."""
    c = _build(256, cap)
    res = c["res"]
    fid, z = c["fwd"][3], c["fwd"][2]
    col = c["col4"][..., :D].contiguous()
    d_out = c["d_out"][..., :D].contiguous()
    full_out = K.aa_fwd(c["rbb"], c["counts"], fid, z, col, res)
    full_dc, _ = K.aa_bwd(c["rbb"], c["counts"], fid, z, col, d_out, res)
    outs, dcs = [], []
    for s in range(sp):
        a = _shard_args(c, s, sp, D)
        got = K.raster_fwd(a["rfb"], a["counts"], res, a["row0"])
        want = K.raster_fwd_plain(a["rfb"], a["counts"], res, a["row0"])
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        for g, w, full in zip(got, want, c["fwd"]):
            assert _max_abs(g, w) < 1e-6
            assert _max_abs(g, full[:, a["rows"]]) < 1e-6
        plane = (a["rbb"], a["counts"], a["fid"], a["z"], a["col"])
        o, sh = K.aa_fwd(*plane, res, a["row0"], a["halo"])
        ow, shw = K.aa_fwd_plain(*plane, res, a["row0"], a["halo"])
        assert _max_abs(o, ow) < 1e-6 and _max_abs(sh, shw) < 1e-6
        dc, ds, dsh = K.aa_bwd(*plane, a["d_out"], res, a["row0"],
                               a["halo_b"])
        dcw, dsw, dshw = K.aa_bwd_plain(*plane, a["d_out"], res, a["row0"],
                                        a["halo_b"])
        assert _max_abs(dc, dcw) < 1e-6 and _max_abs(dsh, dshw) < 1e-6
        assert _max_abs(ds, dsw) <= 1e-5 * float(dsw.abs().max())
        rb = K.raster_bwd(a["rbb"], a["counts"], a["slot"], a["d_col"],
                          a["d_u"], a["d_v"], res, a["row0"])
        rbw = K.raster_bwd_plain(a["rbb"], a["counts"], a["slot"],
                                 a["d_col"], a["d_u"], a["d_v"], res,
                                 a["row0"])
        assert _max_abs(rb, rbw) <= 1e-5 * float(rbw.abs().max())
        if s > 0:
            o[:, 0] += outs[-1][1]
            dc[:, 0] += dcs[-1][1]
        outs.append((o, sh))
        dcs.append((dc, dsh))
    assert _max_abs(torch.cat([o for o, _ in outs], 1), full_out) < 1e-6
    assert _max_abs(torch.cat([d for d, _ in dcs], 1), full_dc) < 1e-6


def two_rank_render(rank, world):
    """A 2-view 256² render on the card, sharded dp = 1 × sp = 2 (gloo,
    ranks sharing the card): the whole images and v's gradient."""
    from largesteps_torch.parallel.sharding import (gather_images,
                                                    make_mesh,
                                                    shard_renderer)
    img, gv, r = _gpu_render(lambda r: shard_renderer(r, make_mesh(1, 2)))
    return {"img": gather_images(img, r), "gv": gv,
            "launches": dict(K.LAUNCHES)}


def _gpu_render(shard=None):
    """Images and v's gradient of icosphere-4 in 2 views of 256² on the
    card, the renderer cut by ``shard``; a seeded weighting of the
    images."""
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.render.renderer import Topology
    s = make_scene(source=("icosphere", 4), target=("gourd", 2), n_views=2,
                   res=256)
    r = Renderer(s, boost=3.0, device="cuda")
    if shard is not None:
        shard(r)
    f = s["mesh-source"]["faces"]
    v = torch.tensor(s["mesh-source"]["vertices"], device="cuda",
                     requires_grad=True)
    with torch.no_grad():
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))
    topo = Topology(f)
    r.check_overflow(v.detach(), topo)
    img = r.render(v, n, topo)
    w = np.random.default_rng(2).normal(size=(2, 256, 256, 4))
    if r.mesh is not None:
        w = w[r.cam_slice, r.row_slice]
    (img * torch.as_tensor(w.astype(np.float32), device="cuda")).sum() \
        .backward()
    return img.detach(), v.grad.cpu().numpy(), r


@pytest.mark.gpu
def test_gpu_two_rank_render():
    """Two gloo ranks sharing the card render one image-row shard each
    through the kernels (halo rows host-staged between them): the gathered
    images equal the unsharded render on the card (1e-5), v's gradient is
    the same on both ranks and 1e-4 × max|g| of the unsharded one."""
    from largesteps_torch.parallel.distributed import launch
    _card()
    img, gv, _ = _gpu_render()
    got = launch(two_rank_render, 2, device="cuda", timeout=240.0)
    for g in got:
        assert all(g["launches"][k] >= 1 for k in K.TILE_KERNELS)
        assert _max_abs(torch.as_tensor(g["img"]), img.cpu()) < 1e-5
        np.testing.assert_array_equal(g["gv"], got[0]["gv"])
        assert np.abs(g["gv"] - gv).max() <= 1e-4 * np.abs(gv).max()


# the coordinates' case: Adam on the vertices, as the remeshing test's
COORDINATES = {"smooth": False, "optimizer": "Adam", "reg": 0.16,
               "loss": "l1", "alpha": 0.95, "step_size": 1e-2}


def two_rank_driver(rank, world, solver):
    """5 steps of the driver on the card, 2 views of 256², sharded dp = 1 ×
    sp = 2; ``solver`` "coordinates" optimizes the vertices themselves
    (``smooth`` off, no solve)."""
    from largesteps_torch.driver import optimize_shape
    s = make_scene(source=("icosphere", 4), target=("gourd", 4), n_views=2,
                   res=256)
    p = {"steps": 5, "step_size": 0.03, "lambda": 19.0, "boost": 3,
         "solver": solver, "sharding": {"dp": 1, "sp": 2}}
    if solver == "coordinates":
        p.update(COORDINATES, solver="Cholesky")
    r = optimize_shape(s, p, device="cuda")
    return r["v_final"], r["losses"], r["prof"].get("solve_iters")


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["CG", "Cholesky", "coordinates"])
def test_gpu_two_rank_driver(solver):
    """Two gloo ranks sharing the card run the sharded driver: the same
    final vertices, losses and CG iterations, bit for bit, on both.  The
    replicated work adds with float atomics on the card, so a CG solve
    starts from rank 0's right-hand side, another solver's solutions are
    rank 0's, and without a solve (``smooth`` off) the coordinates'
    gradients are rank 0's."""
    from largesteps_torch.parallel.distributed import launch
    _card()
    (v0, l0, it0), (v1, l1, it1) = launch(two_rank_driver, 2, device="cuda",
                                          args=(solver,), timeout=240.0)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(it0, it1)
    assert np.isfinite(l0).all() and l0[-1, 0] < l0[0, 0]


@pytest.mark.gpu
def test_gpu_to_differential_is_the_hosts_sum():
    """u = M v of CUDA tensors: the same bits in repeated calls and as the
    product of the same tensors on the CPU (both add each row's entries in
    order; a device ``index_add_`` would add with float atomics, whose
    order varies)."""
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.parameterize import to_differential
    from largesteps_torch.ops.shapes import icosphere
    dev = _card()
    v, f = icosphere(5)
    v = v.astype(np.float32)
    want = to_differential(compute_matrix(v, f, lambda_=19.0, device="cpu"),
                           torch.as_tensor(v))
    M = compute_matrix(v, f, lambda_=19.0, device=dev)
    got = [to_differential(M, torch.as_tensor(v, device=dev))
           for _ in range(3)]
    for u in got:
        assert u.device.type == "cuda"
        torch.testing.assert_close(u.cpu(), want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_bwd_kernels_repeat_to_the_bit(cuda_case, D):
    """raster_bwd and aa_bwd add their per-slot sums in a fixed order: two
    launches on the same inputs give the same bits."""
    c = cuda_case
    raster = lambda: K.raster_bwd(c["rbb"], c["counts"], c["fwd"][4],
                                  c["d_col"], c["d_u"], c["d_v"], c["res"])
    assert torch.equal(raster(), raster())
    args = (c["rbb"], c["counts"], c["fwd"][3], c["fwd"][2],
            c["col4"][..., :D].contiguous(),
            c["d_out"][..., :D].contiguous(), c["res"])
    a, b = K.aa_bwd(*args), K.aa_bwd(*args)
    assert float(a[1].abs().max()) > 0.0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_gpu_main_path_repeats_to_the_bit():
    """Two 5-step runs of the main path (``bench.py:bench_step``'s scene,
    13 views at 256²) on the card: the same bits in every loss and in the
    final vertices."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.profiling import MAIN_PATH_PARAMS, main_path_scene
    dev = _card()
    scene = main_path_scene()
    runs = [optimize_shape(scene, {**MAIN_PATH_PARAMS, "steps": 5},
                           device=dev) for _ in range(2)]
    assert np.isfinite(runs[0]["losses"]).all()
    assert np.array_equal(runs[0]["losses"], runs[1]["losses"])
    assert np.array_equal(runs[0]["v_final"], runs[1]["v_final"])


@pytest.mark.gpu
@pytest.mark.parametrize("res", [128, 96])         # tiles, dense
def test_gpu_render_mesh_image(res):
    """``vis.render_mesh_image`` on the card against the CPU, with the
    wireframe and a highlight: images 1e-5, their masks exact."""
    from largesteps_torch.ops.shapes import icosphere
    from largesteps_torch.vis import render_panel
    dev = _card()
    v, f = icosphere(3)
    hl = np.arange(0, len(f), 29)
    (a, *m_card, _), (b, *m_cpu, _) = (
        render_panel(v, f, res=res, wireframe=True, highlight_faces=hl,
                     device=d) for d in (dev, "cpu"))
    assert a.shape == (res, res, 3) and np.abs(a - b).max() <= 1e-5
    for x, y in zip(m_card, m_cpu):
        assert x.any() and np.array_equal(x, y)


@pytest.mark.gpu
def test_gpu_render_core_gradient():
    """``render_core`` forward and backward on the card (raster_fwd,
    raster_bwd) against the CPU's plain versions: ids exact, u, v and
    colour 1e-5, the gradients of v_clip and of the attributes 1e-4 ×
    max|g|."""
    from largesteps_torch.render.tile_raster import make_render_core
    dev = _card()
    scene = make_scene(source=("icosphere", 3), target=("gourd", 2),
                       n_views=2, res=128)
    f = scene["mesh-source"]["faces"]
    rng = np.random.default_rng(3)
    attrs = rng.normal(size=(len(scene["mesh-source"]["vertices"]), 3))
    wc = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    wu = rng.normal(size=(2, 128, 128, 2)).astype(np.float32)
    core = make_render_core(f, face_adjacency(f), (128, 128), cap=512)
    out = {}
    for d in (dev, "cpu"):
        mvps = Renderer(scene, device=d).mvps
        vc = project(torch.as_tensor(scene["mesh-source"]["vertices"],
                                     device=d), mvps).requires_grad_(True)
        at = torch.as_tensor(attrs.astype(np.float32),
                             device=d).requires_grad_(True)
        rast, slot, col = core(vc, at)
        ((torch.as_tensor(wc, device=d) * col).sum()
         + (torch.as_tensor(wu, device=d) * rast[..., :2]).sum()).backward()
        out[d] = [t.detach().cpu() for t in (rast, slot, col, vc.grad,
                                             at.grad)]
    (r1, s1, c1, gv1, ga1), (r0, s0, c0, gv0, ga0) = out[dev], out["cpu"]
    assert torch.equal(r1[..., 3], r0[..., 3]) and torch.equal(s1, s0)
    assert float((r1[..., :2] - r0[..., :2]).abs().max()) <= 1e-5
    assert float((c1 - c0).abs().max()) <= 1e-5
    for g1, g0 in ((gv1, gv0), (ga1, ga0)):
        assert float((g1 - g0).abs().max()) <= 1e-4 * float(g0.abs().max())


@pytest.mark.gpu
def test_gpu_spans_line_up_with_the_chrome_trace(tmp_path):
    """The driver under ``profiling.trace()`` on the scene of
    ``tests/test_torch_spans.py`` (icosphere-2, 2 views of 64×128, host
    bins, a rebin every 2 steps): every step span's host start, moved by
    the recorder's ``ts_offset_us``, lies within 100 µs of the ``ts`` of
    the same-named range of the trace, and every span timed by events holds
    on its stream interval, within 50 µs, the device work launched inside
    that range (on its thread)."""
    import json
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.profiling import _DEVICE_CATS, trace
    dev = _card()
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=2, res=128)
    scene["res_y"], scene["res_x"] = 64, 128
    with trace(str(tmp_path), "spans") as path:
        res = optimize_shape(scene, {
            "steps": 5, "step_size": 0.01, "lambda": 19.0, "boost": 3,
            "host_bin_faces": 1, "rebin_every": 2, "max_inflight": 1,
            "nan_check_every": 2}, device=dev)
    rec = res["prof"]["trace"]
    off = rec["ts_offset_us"]
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in _DEVICE_CATS
              and "correlation" in e.get("args", {})}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in device]
    steps = [s for s in rec["spans"] if s["step"] is not None]
    timed = 0
    for s in steps:
        t0 = s["host"][0] * 1e6 + off
        r = min(ranges[s["name"]], key=lambda e: abs(e["ts"] - t0))
        assert abs(r["ts"] - t0) <= 100.0, (s["name"], s["step"],
                                            r["ts"] - t0)
        if s["stream"] is None:
            continue
        d0, d1 = (x * 1e6 + off for x in s["stream"])
        inside = [device[e["args"]["correlation"]] for e in launches
                  if e["tid"] == r["tid"]
                  and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        for k in inside:
            assert d0 <= k["ts"] + 50.0, (s["name"], k["name"], d0 - k["ts"])
            assert k["ts"] + k["dur"] <= d1 + 50.0, (
                s["name"], k["name"], k["ts"] + k["dur"] - d1)
        timed += bool(inside)
    names = {s["name"] for s in steps if s["stream"] is not None}
    assert {"solve", "render", "pipe_setup", "backward", "adjoint_solve",
            "pipe_scatter"} <= names
    # the adjoint solve runs on autograd's thread, inside backward()
    assert {s["parent"] for s in steps
            if s["name"] == "adjoint_solve"} == {"backward"}
    assert timed >= len(steps) // 2


def _bunny_leg(eager, monkeypatch, steps, res=256, views=49, **extra):
    """The viewpoints experiment's ``ours`` leg on the bunny scene
    (icosphere-4 to gourd-5, boost 3, α 0.95, l1, AdamUniform at 1e-2)
    for ``steps`` steps; ``eager`` keeps every step out of the graph.
    Returns (result, the optimizer, the tile kernels' launches in the
    call)."""
    from largesteps_torch.core.optimize import AdamUniform
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.render import kernels as K
    drv = importlib.import_module("largesteps_torch.driver.optimize_shape")
    dev = _card()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    with monkeypatch.context() as mp:
        if eager:
            mp.setattr(drv, "_graph_reason",
                       lambda *a: "before_capture")
        scene = make_scene(source=("icosphere", 4), target=("gourd", 5),
                           n_views=views, res=res)
        box = {}
        make = lambda ps, lr: box.setdefault("opt", AdamUniform(ps, lr=lr))
        res_ = optimize_shape(scene, {
            "steps": steps, "step_size": 0.01, "boost": 3, "alpha": 0.95,
            "loss": "l1", "optimizer": make, **extra}, device=dev)
    return res_, box["opt"], dict(K.LAUNCHES)


@pytest.mark.gpu
def test_gpu_step_graph_is_the_eager_fit(monkeypatch):
    """30 steps of the bunny leg at 49 views: the graphed fit (one capture,
    29 replays) and the eager one give the same bits in every logged
    loss, the final vertices and translation, and AdamUniform's moments.
    Both launch the backward tile kernels once a step: the capture counts
    none, a replay one."""
    (rg, og, lg), (re_, oe, le) = (_bunny_leg(e, monkeypatch, 30)
                                   for e in (False, True))
    g, e = rg["prof"]["graph"], re_["prof"]["graph"]
    assert (g["captures"], g["replays"]) == (1, 29)
    for launches in (lg, le):
        assert (launches["raster_bwd"], launches["aa_bwd"]) == (30, 30)
    assert lg == le
    assert g["eager"]["before_capture"] == 1
    assert (e["captures"], e["replays"]) == (0, 0)
    assert np.isfinite(rg["losses"]).all()
    assert np.array_equal(rg["losses"], re_["losses"])
    assert np.array_equal(rg["v_final"], re_["v_final"])
    assert np.array_equal(rg["tr"], re_["tr"])
    for pg, pe in zip(og.param_groups[0]["params"],
                      oe.param_groups[0]["params"]):
        for k in ("g1", "g2"):
            assert torch.equal(og.state[pg][k], oe.state[pe][k]), k


@pytest.mark.gpu
def test_gpu_step_graph_holds_the_eager_peak_memory(monkeypatch):
    """The graphed call's ``max_memory_allocated`` over a 30-step call of
    the bunny leg at 49 views, read as ``perfbench/run.py`` reads it (a
    warm-up call first, its state freed and the peak reset), is at most
    1.01 times the eager call's."""
    peaks = {}
    for eager in (True, False):
        _bunny_leg(eager, monkeypatch, 4)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = _bunny_leg(eager, monkeypatch, 30)[0]
        torch.cuda.synchronize()
        peaks[eager] = torch.cuda.max_memory_allocated()
        assert res["prof"]["graph"]["replays"] == (0 if eager else 29)
        del res
        gc.collect()
    assert peaks[False] <= 1.01 * peaks[True], peaks


@pytest.mark.gpu
def test_gpu_step_graph_recaptures_after_a_remesh(monkeypatch):
    """A remesh at step 4 of a 10-step bunny leg (4 views of 128²; the
    remeshed mesh still bins on the card each step): the old graph goes
    with its epoch (allocated memory lower once it is freed, and no higher
    than the eager run's then), and the new epoch captures again: two captures, one for each epoch, and every
    step but each epoch's first replays a graph."""
    res = _bunny_leg(False, monkeypatch, 10, res=128, views=4, remesh=4)[0]
    eager = _bunny_leg(True, monkeypatch, 10, res=128, views=4, remesh=4)[0]
    g = res["prof"]["graph"]
    (ev,) = res["prof"]["remeshes"]
    # nothing of the old graph outlives its epoch: no more is allocated
    # then than in the eager run
    assert ev["allocated_after"] <= eager["prof"]["remeshes"][0][
        "allocated_after"]
    assert not ev["use_host_bins"]
    assert g["captures"] == len(res["f"]) == 2
    assert g["replays"] == 10 - 2 and g["eager"]["before_capture"] == 2
    assert ev["allocated_after"] < ev["allocated_before"]
    assert np.isfinite(res["losses"]).all()
