"""Parity of the micro-benchmarks' kernels (their plain versions on the CPU)
with the JAX package's two benchmark kernels, which run interpreted off a
TPU: ``benchmarks/micro_scatter.py:onehot_scatter`` and
``benchmarks/probe_mosaic.py:kernel``.  ``benchmarks/`` is not a package,
so both are loaded from their paths.

Tolerances: onehot_scatter 1e-5 × max|out| (the JAX kernel sums in another
order); probe_tile's fields exact (one product by 1 among zeros, both
sides), its sums 1e-5 × max|S|.  Each CUDA kernel is held against its
plain version on the card by ``tests/test_torch_gpu.py``.
"""
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from largesteps_torch.benchmarks import micro_scatter, probe_mosaic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scatter():
    return _load("micro_scatter")


@pytest.fixture(scope="module")
def jax_probe():
    return _load("probe_mosaic")


def _scatter_inputs(C, P, F, ch, seed):
    """Ids from −1 to F (both out of range) and normal rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, F + 1, (C, P)).astype(np.int32)
    ids[0, :3] = [-1, F, 0]
    m = rng.normal(size=(C, P, ch)).astype(np.float32)
    return ids, m


def test_onehot_scatter_plain_matches_jax(jax_scatter):
    C, P, F, ch = 2, 4096, 600, 32
    ids, m = _scatter_inputs(C, P, F, ch, 0)
    want = np.asarray(jax_scatter.onehot_scatter(jnp.asarray(ids),
                                                 jnp.asarray(m), F))
    got = micro_scatter.onehot_scatter(torch.as_tensor(ids),
                                       torch.as_tensor(m), F).numpy()
    assert got.shape == want.shape == (F, ch)
    ok = (ids >= 0) & (ids < F)
    ref = np.zeros((F, ch))
    np.add.at(ref, ids[ok], m[ok].astype(np.float64))
    scale = float(np.abs(ref).max())
    assert np.abs(got - want).max() < 1e-5 * scale
    assert np.abs(got - ref).max() < 1e-5 * scale


@pytest.mark.parametrize("P,ch", [(5000, 18), (3, 5)])
def test_onehot_scatter_plain_any_shape(P, ch):
    """Any P (the JAX kernel pads it to 4,096) and channel count; out of
    range ids add nothing."""
    ids, m = _scatter_inputs(3, P, 50, ch, P)
    got = micro_scatter.onehot_scatter(torch.as_tensor(ids),
                                       torch.as_tensor(m), 50).numpy()
    ok = (ids >= 0) & (ids < 50)
    ref = np.zeros((50, ch))
    np.add.at(ref, ids[ok], m[ok].astype(np.float64))
    assert np.abs(got - ref).max() < 1e-5 * max(np.abs(ref).max(), 1.0)


def test_sort_cumsum_leg_matches_index_add():
    ids, m = _scatter_inputs(2, 3000, 200, 8, 5)
    ids = np.clip(ids, 0, 199)
    got = micro_scatter.sort_cumsum(torch.as_tensor(ids), torch.as_tensor(m),
                                    200).numpy()
    ref = np.zeros((200, 8))
    np.add.at(ref, ids, m.astype(np.float64))
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def _pallas_probe(jax_probe, slot, recT, g0):
    """``probe_mosaic.kernel`` through ``pl.pallas_call``, built as the
    script's ``main`` builds it, in interpret mode."""
    fn = pl.pallas_call(
        jax_probe.kernel,
        out_shape=[jax.ShapeDtypeStruct((32, jax_probe.P), jnp.float32),
                   jax.ShapeDtypeStruct((jax_probe.CAP, 18), jnp.float32)],
        interpret=True)
    fields, S = fn(jnp.asarray(slot), jnp.asarray(recT), jnp.asarray(g0))
    return np.asarray(fields), np.asarray(S)


@pytest.mark.parametrize("kind", ["random", "all_equal"])
def test_probe_tile_plain_matches_pallas(jax_probe, kind):
    cap = jax_probe.CAP
    assert cap == probe_mosaic.CAP
    rng = np.random.default_rng(7)
    slot = rng.integers(-1, cap, (32, 128)).astype(np.float32)
    if kind == "all_equal":
        slot[:] = 17.0
    recT = rng.standard_normal((32, cap)).astype(np.float32)
    g0 = rng.standard_normal((32, 128)).astype(np.float32)
    fields_j, S_j = _pallas_probe(jax_probe, slot, recT, g0)
    fields, S = probe_mosaic.probe_tile(*(torch.as_tensor(a[None])
                                          for a in (slot, recT, g0)))
    np.testing.assert_array_equal(fields[0].numpy(), fields_j)
    assert np.abs(S[0].numpy() - S_j).max() <= 1e-5 * np.abs(S_j).max()
    fo, So = probe_mosaic.oracle(slot[None], recT[None], g0[None])
    np.testing.assert_array_equal(fields.numpy(), fo)


def test_probe_tile_plain_batch_and_no_column_slots():
    """A batch of tiles at cap 768 is the tiles one by one; slot values
    that name no column (fractions, cap, negatives, NaN) give zero fields
    and no sums, −0.0 names column 0."""
    rng = np.random.default_rng(8)
    B, cap = 3, 768
    slot = rng.integers(-1, cap, (B, 32, 128)).astype(np.float32)
    slot[0, 0, :6] = [0.5, cap, -0.5, np.nan, -1e9, -0.0]
    recT = rng.standard_normal((B, 32, cap)).astype(np.float32)
    g0 = rng.standard_normal((B, 32, 128)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (slot, recT, g0)]
    fields, S = probe_mosaic.probe_tile(*t)
    assert fields.shape == (B, 32, 4096) and S.shape == (B, cap, 18)
    for b in range(B):
        fb, Sb = probe_mosaic.probe_tile(*(x[b:b + 1] for x in t))
        assert torch.equal(fb[0], fields[b]) and torch.equal(Sb[0], S[b])
    assert not fields[0, :, :5].any()
    assert torch.equal(fields[0, :, 5], t[1][0, :, 0])
    fo, So = probe_mosaic.oracle(np.nan_to_num(slot, nan=-1.0), recT, g0)
    np.testing.assert_array_equal(fields.numpy(), fo)
    assert np.abs(S.numpy() - So).max() <= 1e-5 * np.abs(So).max()


def test_micro_benchmarks_run_on_the_cpu(capsys):
    """The three scripts' ``main`` at tiny sizes with ``--device cpu``."""
    from largesteps_torch.benchmarks import bench_raster
    out = micro_scatter.main(["--device", "cpu", "--cams", "2", "--px",
                              "3000", "--faces", "300", "--reps", "1"])
    assert out["rel_err_onehot"] < 1e-6 and out["rel_err_sort"] < 1e-4
    out = probe_mosaic.main(["--device", "cpu", "--reps", "1"])
    assert out["fields_max_err"] == 0.0
    assert out["S_max_err"] <= 1e-5 * out["S_max"]
    out = bench_raster.main(["--device", "cpu", "--views", "1", "--res",
                             "128", "--subdiv", "2", "--reps", "1"])
    assert out["id_match"] == 1.0 and out["cap"] >= out["occupancy"]
    text = capsys.readouterr().out
    for line in ("index_add_", "sort+cumsum", "bin topk", "fields max err",
                 "dense fwd:", "tiles fwd:", "dense fwd+bwd:",
                 "max bin occupancy", "id match"):
        assert line in text, line


def test_micro_benchmark_kernels_launch_only_on_the_card():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    n = dict(micro_scatter.LAUNCHES, **probe_mosaic.LAUNCHES)
    micro_scatter.onehot_scatter(torch.zeros((1, 4), dtype=torch.int32),
                                 torch.ones((1, 4, 2)), 3)
    probe_mosaic.probe_tile(torch.zeros((1, 32, 128)),
                            torch.ones((1, 32, 4)), torch.ones((1, 32, 128)))
    assert dict(micro_scatter.LAUNCHES, **probe_mosaic.LAUNCHES) == n
    with pytest.raises(ValueError):
        micro_scatter.onehot_scatter(torch.zeros((1, 4), dtype=torch.int32),
                                     torch.ones((1, 5, 2)), 3)
    with pytest.raises(ValueError):
        probe_mosaic.probe_tile(torch.zeros((1, 32, 64)),
                                torch.ones((1, 32, 4)),
                                torch.ones((1, 32, 128)))


def _slot_table(C, TY, TX, cap, F, seed):
    """bins (C, TY, TX, cap) as the binning lays them out (each tile's live
    faces in ascending order, then −1) and a normal (..., cap, 18) table."""
    rng = np.random.default_rng(seed)
    bins = np.full((C, TY, TX, cap), -1, np.int64)
    for idx in np.ndindex(C, TY, TX):
        n = int(rng.integers(0, cap + 1))
        bins[idx][:n] = np.sort(rng.choice(F, n, replace=False))
    table = rng.normal(size=(C, TY, TX, cap, 18)).astype(np.float32)
    return bins, table


@pytest.mark.parametrize("C", [1, 2])
def test_onehot_scatter_plain_on_scatter_via_faces_layout(C):
    """The segment sum of the main path's backward: ``onehot_scatter`` over
    ``face_ids`` (each slot's face, empty slots on a sentinel row a camera)
    into C·(F + 1) rows is ``face_sums``, the table that the port's
    ``scatter_via_faces`` builds, and through the face→vertex gather gives
    both the port's and JAX's ``_scatter_via_faces``
    (``pallas_core.py:1260``)."""
    from largesteps_torch.ops.shapes import icosphere
    from largesteps_torch.render import pipeline as tp
    from largesteps_tpu.render import pallas_core as pc
    v, f = icosphere(2)
    F, V = f.shape[0], v.shape[0]
    bins, table = _slot_table(C, 2, 2, 96, F, C)
    bins_t, table_t = torch.as_tensor(bins), torch.as_tensor(table)
    ids = tp.face_ids(bins_t, F).to(torch.int32).reshape(1, -1)
    got = micro_scatter.onehot_scatter(ids, table_t.reshape(1, -1, 18),
                                       C * (F + 1))
    want = tp.face_sums(table_t, bins_t, F)
    scale = float(want.abs().max())
    assert got.shape == want.shape == (C * (F + 1), 18)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    # the sentinel rows hold the empty slots' sums
    empty = table[bins < 0].astype(np.float64).reshape(-1, 18)
    assert np.abs(got.reshape(C, F + 1, 18)[:, F].sum(0).numpy()
                  - empty.sum(0)).max() <= 1e-4 * scale
    inc = tp.build_incidence(f, V)
    inc_t = (torch.as_tensor(inc[0]), torch.as_tensor(
        inc[1].astype(np.float32)))
    dv, da = tp._faces_to_vertices(got.reshape(C, F + 1, 18), inc_t)
    dv_p, da_p = tp.scatter_via_faces(table_t, bins_t, inc_t, F, V)
    dv_j, da_j = pc._scatter_via_faces(jnp.asarray(table), jnp.asarray(bins),
                                       pc.build_incidence(f, V), F, V)
    for a, b, c in ((dv, dv_p, dv_j), (da, da_p, da_j)):
        s = float(np.abs(np.asarray(c)).max())
        assert float((a - b).abs().max()) <= 1e-5 * s
        assert np.abs(a.numpy() - np.asarray(c)).max() <= 1e-5 * s
