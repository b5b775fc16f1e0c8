"""Parity of the port's four kernels (their plain PyTorch versions on the
CPU) and of the pipeline glue with the JAX package's Pallas kernels.

Both sides get the SAME records and bins, built by the JAX package's
``_setup_and_bin`` and passed as numpy, so slot ids agree by construction.
The JAX kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them.  Size: 1 camera, 128×128 (4 tiles), icosphere-2, cap 256.

Tolerances: face and slot ids exact; images 1e-5 absolute; gradient sums
1e-4 × max|g| (the JAX kernels gather with a 3-term and reduce with a
2-term bf16 split, ~2⁻²⁴ and ~2⁻¹⁶ relative; the port sums in float32 in
another order).

Each CUDA kernel is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.antialias import face_adjacency
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.renderer import Renderer as JRenderer

from largesteps_torch.render import kernels as K
from largesteps_torch.render import pipeline as tp

H = W = 128
RES = (H, W)
CAP = 256
T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module")
def case():
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=1, res=H)
    v = jnp.asarray(scene["mesh-source"]["vertices"])
    f = np.asarray(scene["mesh-source"]["faces"], np.int32)
    opp = face_adjacency(f)
    mvps = JRenderer(scene, backend="xla").mvps
    v_ndc = j_project(v, mvps)
    rng = np.random.default_rng(0)
    attrs = rng.normal(size=(v.shape[0], 3)).astype(np.float32)
    rfb, rbb, bins, counts = pc._setup_and_bin(
        v_ndc, jnp.asarray(f), jnp.asarray(attrs), jnp.asarray(opp), H, W, CAP)
    j = dict(v_ndc=np.asarray(v_ndc), f=f, opp=opp, attrs=attrs,
             rfb=np.asarray(rfb), rbb=np.asarray(rbb),
             bins=np.asarray(bins), counts=np.asarray(counts))
    outs = pc.raster_fwd_pallas(rfb, counts, RES, CAP, chunk=128)
    j["fwd"] = [np.asarray(o) for o in outs]
    fid, z = outs[3], outs[2]
    col = jnp.stack(outs[5:8], -1)
    cov = (fid > 0)[..., None]
    col4 = jnp.where(cov, jnp.concatenate([col, cov.astype(col.dtype)], -1),
                     jnp.asarray(rng.uniform(size=(1, H, W, 4)), jnp.float32))
    j["col4"] = np.asarray(col4)
    j["d_out"] = rng.normal(size=(1, H, W, 4)).astype(np.float32)
    j["d_col"] = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    j["d_u"] = rng.normal(size=(1, H, W)).astype(np.float32)
    j["d_v"] = rng.normal(size=(1, H, W)).astype(np.float32)
    return j


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-30)


def test_raster_fwd_plain_matches_pallas(case):
    got = K.raster_fwd(T(case["rfb"]), T(case["counts"]), RES)
    want = case["fwd"]
    names = ["u", "v", "z", "fid", "slot", "c0", "c1", "c2"]
    np.testing.assert_array_equal(N(got[3]), want[3])     # fid exact
    np.testing.assert_array_equal(N(got[4]), want[4])     # slot exact
    assert (want[3] > 0).sum() > 1000                      # a real image
    # z comes straight out of the z-loop on both sides
    assert np.max(np.abs(N(got[2]) - want[2])) < 1e-6
    # u, v and colour: the JAX kernel fetches the winner's coefficients
    # with a 3-term bf16 one-hot matmul (~2⁻²⁴ relative per coefficient),
    # which the cancellation in q = a·px + b·py + c amplifies to ~4e-5 at
    # a handful of 16k pixels; the port indexes the record exactly
    for k in (0, 1, 5, 6, 7):
        err = np.max(np.abs(N(got[k]) - want[k]))
        assert err < 1e-4, (names[k], err)
    # exact-gather reference in numpy float32: the port matches it
    slot = want[4].astype(np.int64)[0]
    rec = case["rfb"][0].reshape(4 * CAP, 32)
    ty = np.arange(H)[:, None] // 32
    f = np.where((slot >= 0)[..., None], rec[ty * CAP + np.maximum(slot, 0)],
                 0.0).astype(np.float32)
    px = ((np.arange(W, dtype=np.float32) + np.float32(0.5))
          * np.float32(2.0 / W) - np.float32(1.0))[None, :]
    py = ((np.arange(H, dtype=np.float32) + np.float32(0.5))
          * np.float32(2.0 / H) - np.float32(1.0))[:, None]
    q0 = f[..., 0] * px + f[..., 1] * py + f[..., 2]
    s = f[..., 6] * px + f[..., 7] * py + f[..., 8]
    u = q0 * (np.float32(1.0) / np.where(s == 0, np.float32(1.0), s))
    np.testing.assert_array_equal(N(got[0])[0], u)


def test_aa_fwd_plain_matches_pallas(case):
    fid, z = case["fwd"][3], case["fwd"][2]
    want = pc.aa_fwd_pallas(jnp.asarray(case["rbb"]),
                            jnp.asarray(case["counts"]), jnp.asarray(fid),
                            jnp.asarray(z), jnp.asarray(case["col4"]), RES,
                            CAP, D=4)
    got = K.aa_fwd(T(case["rbb"]), T(case["counts"]), T(fid), T(z),
                   T(case["col4"]), RES)
    assert np.max(np.abs(N(got) - np.asarray(want))) < 1e-5
    assert np.max(np.abs(np.asarray(want) - case["col4"])) > 1e-2  # blends


def test_raster_bwd_plain_matches_pallas(case):
    slot = case["fwd"][4]
    want = pc.raster_bwd_pallas(
        jnp.asarray(case["rbb"]), jnp.asarray(case["counts"]),
        jnp.asarray(slot), jnp.asarray(case["d_col"]),
        jnp.asarray(case["d_u"]), jnp.asarray(case["d_v"]), RES, CAP)
    got = K.raster_bwd(T(case["rbb"]), T(case["counts"]), T(slot),
                       T(case["d_col"]), T(case["d_u"]), T(case["d_v"]), RES)
    want = np.asarray(want)
    for col in range(18):
        assert _max_rel(N(got)[..., col], want[..., col]) < 1e-4, col
    assert np.all(N(got)[..., 18:] == 0.0)


def test_aa_bwd_plain_matches_pallas(case):
    fid, z = case["fwd"][3], case["fwd"][2]
    dc_want, ds_want = pc.aa_bwd_pallas(
        jnp.asarray(case["rbb"]), jnp.asarray(case["counts"]),
        jnp.asarray(fid), jnp.asarray(z), jnp.asarray(case["col4"]),
        jnp.asarray(case["d_out"]), RES, CAP, D=4)
    dc, ds = K.aa_bwd(T(case["rbb"]), T(case["counts"]), T(fid), T(z),
                      T(case["col4"]), T(case["d_out"]), RES)
    assert np.max(np.abs(N(dc) - np.asarray(dc_want))) < 1e-5
    ds_want = np.asarray(ds_want)
    assert np.abs(ds_want[..., :6]).max() > 0.0
    for col in range(6):
        assert _max_rel(N(ds)[..., col], ds_want[..., col]) < 1e-4, col
    assert np.all(N(ds)[..., 6:] == 0.0)


def test_setup_and_bin_matches(case):
    dev_f = torch.as_tensor(case["f"].astype(np.int64))
    dev_o = torch.as_tensor(case["opp"].astype(np.int64))
    rfb, rbb, bins, counts = tp.setup_and_bin(
        T(case["v_ndc"]), dev_f, T(case["attrs"]), dev_o, H, W, CAP)
    np.testing.assert_array_equal(N(bins), case["bins"])
    np.testing.assert_array_equal(N(counts), case["counts"])
    np.testing.assert_allclose(N(rfb), case["rfb"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(rbb), case["rbb"], rtol=1e-6, atol=1e-6)
    occ = tp.check_bin_overflow(T(case["v_ndc"]), dev_f, RES)
    assert occ == pc.check_bin_overflow(jnp.asarray(case["v_ndc"]),
                                        jnp.asarray(case["f"]), RES)
    assert tp.suggest_cap(occ) == pc.suggest_cap(occ)


def test_chain_planes_and_scatter_match(case):
    rng = np.random.default_rng(1)
    dslot = rng.normal(size=(1, 4, 1, CAP, 32)).astype(np.float32)
    dslot_aa = rng.normal(size=(1, 4, 1, CAP, 8)).astype(np.float32)
    dslot[0, 0, 0, 3, 2] = np.inf              # the sliver guard drops it
    want = pc._chain_planes(jnp.asarray(dslot), jnp.asarray(dslot_aa), 3.0,
                            jnp.asarray(case["rbb"]))
    got = tp.chain_planes(T(dslot), T(dslot_aa), 3.0, T(case["rbb"]))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(N(got)).all()

    n_verts = case["v_ndc"].shape[1]
    F = case["f"].shape[0]
    inc = pc.build_incidence(case["f"], n_verts)
    inc_t = tp.build_incidence(case["f"], n_verts)
    np.testing.assert_array_equal(inc_t[0], inc[0])
    dv_want, da_want = pc._scatter_via_faces(want, jnp.asarray(case["bins"]),
                                             inc, F, n_verts)
    dv, da = tp.scatter_via_faces(
        got, T(case["bins"]), (T(inc_t[0]), T(inc_t[1].astype(np.float32))),
        F, n_verts)
    np.testing.assert_allclose(N(dv), np.asarray(dv_want), rtol=1e-5,
                               atol=1e-5 * np.abs(dv_want).max())
    np.testing.assert_allclose(N(da), np.asarray(da_want), rtol=1e-5,
                               atol=1e-5 * np.abs(da_want).max())


def test_wrappers_reject_other_devices(case):
    with pytest.raises(ValueError, match="device"):
        K.raster_fwd(T(case["rfb"]).to("meta"), T(case["counts"]).to("meta"),
                     RES)


@pytest.mark.parametrize("bad", ["channels", "two_channels", "tiles",
                                 "aligned"])
def test_aa_checks_reject_what_the_kernels_do_not_take(bad):
    """The antialias kernels take 3 or 4 channels on planes that match the
    bins' tiles, 16-byte aligned when D = 4 (checked before any launch)."""
    rec = torch.zeros((1, 4, 1, 8, 32))
    D = {"channels": 5, "two_channels": 2}.get(bad, 4)
    H = 96 if bad == "tiles" else 128
    color = torch.zeros((1, H, 128, D))
    if bad == "aligned":
        color = torch.zeros(1 * 128 * 128 * 4 + 1)[1:].reshape(1, 128, 128, 4)
    with pytest.raises(ValueError):
        K._aa_checks("aa_fwd", rec, color, (H, 128))
    K._aa_checks("aa_fwd", rec, torch.zeros((1, 128, 128, 3)), (128, 128))
