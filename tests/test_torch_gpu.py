"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests import neither jax nor largesteps_tpu, so they run on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  Without
a card they skip: the kernels have no CPU mode.

Inputs: icosphere-4 (5,120 faces) in one 128×128 view, so each of the four
tiles holds over a thousand faces and the kernels' shared-memory chunk loops
run more than once.  ``cap`` is the fitted cap (the per-slot tables sit in
shared memory) or 9216 (the tables do not fit, and the kernels accumulate
with global atomics).  Attributes, colours and cotangents come from a numpy
seed.

Tolerances: face and slot ids exact, the other forward planes 1e-6 absolute
(the library is built with ``-fmad=false`` and repeats the plain version's
operations in order); per-slot sums 1e-5 × max|sum| (atomics add in another
order than ``index_add_``).
"""
import numpy as np
import pytest
import torch

from largesteps_torch.io.synth import make_scene
from largesteps_torch.render import kernels as K
from largesteps_torch.render.antialias import face_adjacency
from largesteps_torch.render.camera import project
from largesteps_torch.render.pipeline import (check_bin_overflow,
                                              setup_and_bin, suggest_cap)
from largesteps_torch.render.renderer import Renderer

H = W = 128
RES = (H, W)


@pytest.fixture(params=["fit", 9216])
def cuda_case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene = make_scene(source=("icosphere", 4), target=("gourd", 2),
                       n_views=1, res=H)
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64), device=dev)
    opp = torch.as_tensor(face_adjacency(f).astype(np.int64), device=dev)
    mvps = Renderer(scene, device=dev).mvps
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"],
                                    device=dev), mvps)
    occ = check_bin_overflow(v_ndc, faces, RES)
    cap = suggest_cap(occ) if request.param == "fit" else request.param
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    attrs = as_t(rng.normal(size=(v_ndc.shape[1], 3)))
    rfb, rbb, bins, counts = setup_and_bin(v_ndc, faces, attrs, opp, H, W,
                                           cap)
    fwd = [p.contiguous() for p in K.raster_fwd_plain(rfb, counts, RES)]
    fid = fwd[3]
    cov = (fid > 0)[..., None]
    col4 = torch.where(cov, torch.cat([torch.stack(fwd[5:8], -1),
                                       cov.float()], -1),
                       as_t(rng.uniform(size=(1, H, W, 4))))
    return {"occ": occ, "cap": cap, "rfb": rfb, "rbb": rbb,
            "counts": counts, "fwd": fwd, "col4": col4.contiguous(),
            "d_out": as_t(rng.normal(size=(1, H, W, 4))),
            "d_col": as_t(rng.normal(size=(1, H, W, 3))),
            "d_u": as_t(rng.normal(size=(1, H, W))),
            "d_v": as_t(rng.normal(size=(1, H, W)))}


def _max_abs(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
def test_gpu_raster_fwd(cuda_case):
    c = cuda_case
    assert int(c["counts"].max()) > 256          # several smem chunks
    n0 = K.LAUNCHES["raster_fwd"]
    got = K.raster_fwd(c["rfb"], c["counts"], RES)
    torch.cuda.synchronize()
    assert K.LAUNCHES["raster_fwd"] == n0 + 1
    want = c["fwd"]
    assert int((want[3] > 0).sum()) > 1000       # a real image
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for a, b in zip(got, want):
        assert _max_abs(a, b) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_aa_fwd(cuda_case, D):
    c = cuda_case
    fid, z = c["fwd"][3], c["fwd"][2]
    col = c["col4"][..., :D].contiguous()
    n0 = K.LAUNCHES["aa_fwd"]
    got = K.aa_fwd(c["rbb"], c["counts"], fid, z, col, RES)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aa_fwd"] == n0 + 1
    want = K.aa_fwd_plain(c["rbb"], c["counts"], fid, z, col, RES)
    assert _max_abs(want, col) > 1e-2            # pairs blend
    assert _max_abs(got, want) < 1e-6


@pytest.mark.gpu
def test_gpu_raster_bwd(cuda_case):
    c = cuda_case
    args = (c["rbb"], c["counts"], c["fwd"][4], c["d_col"], c["d_u"],
            c["d_v"], RES)
    n0 = K.LAUNCHES["raster_bwd"]
    got = K.raster_bwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["raster_bwd"] == n0 + 1
    want = K.raster_bwd_plain(*args)
    assert _max_abs(got, want) < 1e-5 * float(want.abs().max())
    assert bool((got[..., 18:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4, 3])            # shaded, silhouette
def test_gpu_aa_bwd(cuda_case, D):
    c = cuda_case
    args = (c["rbb"], c["counts"], c["fwd"][3], c["fwd"][2],
            c["col4"][..., :D].contiguous(),
            c["d_out"][..., :D].contiguous(), RES)
    n0 = K.LAUNCHES["aa_bwd"]
    dc, ds = K.aa_bwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aa_bwd"] == n0 + 1
    dcw, dsw = K.aa_bwd_plain(*args)
    assert float(dsw.abs().max()) > 0.0
    assert _max_abs(dc, dcw) < 1e-6
    assert _max_abs(ds, dsw) < 1e-5 * float(dsw.abs().max())
    assert bool((ds[..., 6:] == 0).all())
