"""CPU tests of the port's benchmark harness (``perfbench/``).

    python -m pytest perfbench/tests -q

The cells themselves run only on the card (``python3 -m perfbench.run``);
here test-only cells (``tests/data``: icosphere-2 fitted to gourd-2, two
views at 128²; ``tiny-ours`` solves, ``tiny-reg`` optimizes the coordinates
under Adam with the bilaplacian term) drive whole runs on the CPU, where
the program's kernel wrappers take their plain PyTorch versions.
"""
import ast
import io
import json
import os
import re
import contextlib

import numpy as np
import pytest
import torch

from perfbench import check, reference, roofline, run, scene

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
DATA = os.path.join(HERE, "data")
ROOTS = (DATA, run.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "largesteps_tpu"}
# the yardstick: the reference and everything it rests on
REFERENCE = ("reference.py", "scene.py", "check.py", "roofline.py",
             "trace.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_names_and_units_keep_to_their_characters():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    names += [w["config"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in b[k]]
    assert all(UNIT.match(u) for u in units), units
    assert len(set(names[:len(names) - 2 * len(b["workloads"])])) \
        == len(names) - 2 * len(b["workloads"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic",
                                  "metrics"])
def test_each_file_loads_by_name(kind):
    b = bench()
    if kind == "configs":
        for c in b["configs"]:
            assert os.path.samefile(run.find("configs", c["name"]),
                                    os.path.join(ROOT, c["file"]))
            assert run.load("configs", c["name"])["name"] == c["name"]
    elif kind == "workloads":
        for w in b["workloads"]:
            wl, cfg, tr, params = run.cell(w["name"])
            assert (wl["config"], wl["traffic"], wl["chips"]) == \
                (w["config"], w["traffic"], w["chips"])
            assert set(wl["limits"]) == set(check.NUMBERS)
    elif kind == "traffic":
        for w in b["workloads"]:
            assert run.load("traffic", w["traffic"])["name"] == w["traffic"]
    else:
        for m in b["per_layer"]:
            assert callable(run.reader(m["name"]))


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for f in REFERENCE:
        tops = {m.split(".")[0] for m in _imports(os.path.join(PB, f))}
        assert "largesteps_torch" not in tops, f


@pytest.mark.parametrize("cfg,views", [("nefertiti", 13), ("bunny", 49)])
def test_frozen_scene_is_the_ports_byte_for_byte(cfg, views):
    from largesteps_torch.io.synth import make_scene
    spec = run.load("configs", cfg)["scene"]
    kw = dict(source=tuple(spec["source"]), target=tuple(spec["target"]),
              n_views=views, res=spec["res"], seed=123456789)
    a, b = scene.make_scene(**kw), make_scene(**kw)
    assert sorted(a) == sorted(b)
    for k in a:
        if k.startswith("mesh-"):
            for part in ("vertices", "faces"):
                x, y = a[k][part], b[k][part]
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        elif k == "view_mats":
            assert all(x.tobytes() == y.tobytes() for x, y in zip(a[k], b[k]))
        elif isinstance(a[k], np.ndarray):
            assert a[k].tobytes() == b[k].tobytes()
        else:
            assert a[k] == b[k]


def test_seeds_change_inputs_not_sizes():
    spec = run.load("configs", "bunny")["scene"]
    a = scene.scene_for(spec, 49, 2 ** 31 + 12345)
    b = scene.scene_for(spec, 49, 2 ** 31 + 12345)
    c = scene.scene_for(spec, 49, 7)
    assert a["envmap"].tobytes() == b["envmap"].tobytes()
    assert a["envmap"].tobytes() != c["envmap"].tobytes()
    assert a["view_mats"][0].tobytes() != c["view_mats"][0].tobytes()
    assert a["mesh-source"]["faces"].shape == c["mesh-source"]["faces"].shape


def test_roofline_counts_a_hand_sized_mesh():
    # one triangle, the lower-left half of a 4 × 4 view: 16 pixel centres
    # in its box, 10 on or under its diagonal x + y = 0, one change of
    # face along each of three rows and three columns
    clip = torch.tensor([[[-1.0, -1.0, 0.5, 1.0], [1.0, -1.0, 0.5, 1.0],
                          [-1.0, 1.0, 0.5, 1.0]]])
    w = reference.count_clip(clip, torch.tensor([[0, 1, 2]]), (4, 4))
    assert (w["z_tests"], w["covered"], w["pairs"]) == (16, 10, 6)
    flops, nbytes = roofline.tile_work(w)
    # 22·16 + 20·10 + (75 + 6·4)·6 + 100·10 + (75 + 60 + 12·4)·6
    assert flops == 3244
    # positions 12, shading 9, faces and neighbours 6; forward: those, the
    # backgrounds 64, image 64, planes 64; backward: image gradient 64,
    # planes 64, those again, position and shading gradients 21; 4 bytes
    assert nbytes == 4 * ((27 + 64 * 3) + (64 * 2 + 27 + 21))
    assert roofline.least_seconds(flops, nbytes) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))


def _rehearse(monkeypatch=None, plant=None, trace=0, bench_file=None,
              workload="tiny-ours"):
    out, err = io.StringIO(), io.StringIO()
    kw = dict(roots=ROOTS, device="cpu", require_card=False, plant=plant)
    if bench_file:
        kw["bench_file"] = bench_file
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run.main(["--workload", workload, "--seed", "3000000019",
                         "--seconds", "1", "--trace", str(trace)], **kw)
    return code, json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


# the smooth leg (u = M v, AdamUniform) and the coordinate leg (Adam on v)
CELLS = ["tiny-ours", "tiny-reg"]


def _tiny(workload, seed=1234):
    wl, cfg, tr, params = run.cell(workload, ROOTS)
    scn = scene.scene_for(cfg["scene"], tr["views"], seed)
    return wl, scn, params


@pytest.mark.parametrize("workload", CELLS)
def test_a_cpu_rehearsal_prints_the_contracts_last_line(workload):
    code, line, err = _rehearse(workload=workload)
    assert code == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"steps_per_s", "step_ms_p95",
                                    "peak_mem_gib", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k in check.NUMBERS:
        assert f"check {k}:" in err
    assert err.strip().splitlines()[-1] == "correct: True"


def test_a_new_metric_is_a_new_file(tmp_path):
    # a per-layer metric added as a file of its own (tests/data/metrics)
    # and listed in a benchmark file, with no edit to the harness
    b = bench()
    b["per_layer"] = [{"name": "tiny_window_steps", "unit": "steps",
                       "better": "higher", "source": "program_counter",
                       "layer": "driver", "moves": "steps_per_s",
                       "workloads": ["tiny-ours"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    code, line, _ = _rehearse(trace=1, bench_file=str(path))
    assert code == 0
    assert line["metrics"] == {"tiny_window_steps": {
        "value": float(line["attempted"]), "unit": "steps"}}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_comparison(workload):
    wl, scn, params = _tiny(workload)
    ref = reference.Reference(scn, params, "cpu")
    theta = {"u": ref.u0() * 1.001, "tr": torch.full((1, 3), 1e-3)}
    r = check.side_outputs(ref, theta)
    ctl = check.side_outputs(
        reference.Reference(scn, params, "cpu", lowp=True), theta)
    nums = check.numbers(ctl, r, ref)
    assert not check.judge(nums, wl["limits"]), nums
    # the reference against itself passes
    assert check.judge(check.numbers(r, r, ref), wl["limits"])


def _freeze_steps():
    from largesteps_torch.core import optimize
    optimize.AdamUniform.step = lambda self, closure=None: None
    optimize.Adam.step = lambda self, closure=None: None


def _half_views():
    from largesteps_torch.render import renderer
    init = renderer.Renderer.__init__

    def half(self, scene_params, *a, **k):
        sp = dict(scene_params)
        sp["view_mats"] = list(sp["view_mats"])[:len(sp["view_mats"]) // 2]
        init(self, sp, *a, **k)

    renderer.Renderer.__init__ = half


def _roll_row():
    from largesteps_torch.render import renderer
    render = renderer.Renderer.render

    def rolled(self, *a, **k):
        imgs = render(self, *a, **k)
        if not torch.is_grad_enabled():     # the targets, made once
            return imgs
        return torch.roll(imgs, 1, dims=1)

    renderer.Renderer.render = rolled


def _restore_after(monkeypatch):
    """Puts back, after the test, what a planted fault replaces."""
    from largesteps_torch.core import optimize
    from largesteps_torch.render import renderer
    for cls in (optimize.AdamUniform, optimize.Adam):
        monkeypatch.setattr(cls, "step", cls.step)
    monkeypatch.setattr(renderer.Renderer, "__init__",
                        renderer.Renderer.__init__)
    monkeypatch.setattr(renderer.Renderer, "render",
                        renderer.Renderer.render)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_freeze_steps, _half_views, _roll_row])
def test_a_broken_timed_path_reads_not_correct(fault, workload, monkeypatch):
    _restore_after(monkeypatch)
    code, line, err = _rehearse(plant=fault, workload=workload)
    assert code == 0
    assert line["correct"] is False, line["checks"]
    assert err.strip().splitlines()[-1] == "correct: False"


def test_count_work_of_the_coordinate_leg_renders_u_plus_tr():
    _, scn, params = _tiny("tiny-reg")
    ref = reference.Reference(scn, params, "cpu")
    # no M: the parameters are the welded source vertices themselves
    assert ref.M is None
    assert torch.equal(ref.u0(), torch.as_tensor(ref.v_unique))
    u, tr = ref.u0() * 1.01, torch.full((1, 3), 2e-3)
    want = reference.count_clip(
        reference.project(u[ref.dup_t] + tr, ref.mvps), ref.faces, ref.res)
    # the same float32 sums in the same order: equal, not close
    assert reference.count_work(ref, u, tr) == want


def test_a_smooth_leg_keeps_its_solve_in_numbers_and_count_work():
    _, scn, params = _tiny("tiny-ours")
    ref = reference.Reference(scn, params, "cpu")
    u, tr = ref.u0() * 1.001, torch.full((1, 3), 1e-3)
    # the work of M⁻¹u, as counted before coordinate legs were taught
    v = reference.Solve.apply(u, ref.M)[ref.dup_t] + tr
    want = reference.count_clip(reference.project(v, ref.mvps), ref.faces,
                                ref.res)
    assert reference.count_work(ref, u, tr) == want
    r = check.side_outputs(ref, {"u": u, "tr": tr})
    o = {**r, **{k: {n: g + 1e-2 * g.roll(1, 0) for n, g in r[k].items()}
                 for k in ("grad0", "grad_last")}}
    nums = check.numbers(o, r, ref)
    # the gradients in v-space as M ∂L/∂u: the same float64 products, so
    # the same bits
    gv = lambda g: ref.M.mv(g["u"].double())
    assert nums["grad_first"] == reference.row_gap(gv(o["grad0"]),
                                                   gv(r["grad0"]))
    assert nums["grad_last"] == reference.row_gap(gv(o["grad_last"]),
                                                  gv(r["grad_last"]))
    # and not the u-space gap (0.01 here): M spreads the shifted rows
    # over their neighbours, some 0.38 in v-space
    assert nums["grad_first"] > 10 * reference.row_gap(o["grad0"]["u"],
                                                       r["grad0"]["u"])


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = run.main(["--workload", "nefertiti-ours", "--seed", "1",
                         "--seconds", "1"])
    assert code != 0 and out.getvalue() == ""


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), float("inf")])
    want = torch.tensor([1.0, 1.0 + 4 * 2 ** -11, 1.0,
                         -(1.0 + 4 * 2 ** -11), float("inf")])
    assert torch.equal(reference.tf32(x), want)


@pytest.mark.gpu
def test_the_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = run.main(["--workload", "tiny-ours", "--seed", "5",
                         "--seconds", "1", "--trace", "1"], roots=ROOTS)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert code == 0 and line["correct"] is True
    assert line["device"]["busy_s"] > 0
