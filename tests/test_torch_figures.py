"""The port's viewpoints, influence and reg_fail experiments against the JAX
experiments' scripts.

Each ``python -m largesteps_torch.figures.<name>`` runs its ``--quick``
legs on the CPU on a tiny scene (icosphere-2 fitted to gourd-2, 2 views of
32², 2 steps a leg) into a temporary ``LS_OUTPUT_DIR``; the files it writes
must carry the names that ``figures/<name>/generate_data.py`` gives its
legs and the columns that ``figures/common.py`` writes, and its constants
must be the JAX script's (read from the scripts' source, which imports jax
at its top and runs its legs under ``__main__``).
"""
import ast
import csv
import os

import pytest

from largesteps_torch.figures import common, influence, reg_fail, viewpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(source=("icosphere", 2), target=("gourd", 2), n_views=2, res=32)


def _jax_source(path):
    with open(os.path.join(ROOT, "figures", *path)) as fh:
        return ast.parse(fh.read())


def _jax_constants(exp):
    """The module-level literal assignments of the JAX experiment."""
    out = {}
    for node in _jax_source((exp, "generate_data.py")).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _jax_columns():
    """The header rows ``figures/common.py:run`` writes: loss, metrics."""
    rows = [ast.literal_eval(n.args[0])
            for n in ast.walk(_jax_source(("common.py",)))
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "writerow" and isinstance(n.args[0], ast.List)
            and all(isinstance(e, ast.Constant) for e in n.args[0].elts)]
    assert len(rows) == 2
    return rows


def _names(exp):
    """The JAX script's quick leg names, by its naming rules, at the
    port's quick settings."""
    if exp == "viewpoints":
        n = viewpoints.CAMS[viewpoints.QUICK]
        return [f"views_{n}_ours", f"views_{n}_reg"]
    if exp == "influence":
        return [f"alpha_{a:g}" for a in influence.QUICK_ALPHAS]
    return ["ours"] + [f"reg_{w:g}" for w in reg_fail.QUICK_WEIGHTS]


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("LS_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(common, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.setitem(common.SCENES, "bunny", TINY)
    monkeypatch.setitem(common.SCENES, "suzanne", TINY)
    # the quick viewpoints pair at 2 views (the JAX script's quick leg,
    # CAMS[2] = 4 views, past this test's size)
    monkeypatch.setattr(viewpoints, "CAMS",
                        [2 if i == viewpoints.QUICK else n
                         for i, n in enumerate(viewpoints.CAMS)])
    for mod in (viewpoints, influence, reg_fail):
        monkeypatch.setattr(mod, "QUICK_STEPS", 2)
    return str(tmp_path)


def test_constants_are_the_jax_scripts():
    v = _jax_constants("viewpoints")
    assert (v["CAMS"], v["STEPS_OURS"], v["STEPS_REG"], v["COMMON"]) == (
        viewpoints.CAMS, viewpoints.STEPS_OURS, viewpoints.STEPS_REG,
        viewpoints.COMMON)
    assert _jax_constants("influence")["ALPHAS"] == influence.ALPHAS
    assert _jax_constants("reg_fail")["COMMON"] == reg_fail.COMMON


@pytest.mark.parametrize("exp", ["viewpoints", "influence", "reg_fail"])
def test_quick_writes_the_jax_files(exp, tiny):
    mod = {"viewpoints": viewpoints, "influence": influence,
           "reg_fail": reg_fail}[exp]
    scenes_before = dict(common.SCENES)
    out = mod.main(["--quick", "--device", "cpu"])
    names = _names(exp)
    assert sorted(out) == sorted(names)
    assert common.SCENES == scenes_before       # no bunny_{n} left behind
    d = os.path.join(tiny, exp)
    assert sorted(os.listdir(d)) == sorted(
        n + s for n in names for s in ("_final.ply", "_loss.csv",
                                       "_metrics.csv"))
    loss_cols, metric_cols = _jax_columns()
    for n in names:
        with open(os.path.join(d, n + "_loss.csv")) as fh:
            rows = list(csv.reader(fh))
        assert rows[0] == loss_cols and len(rows) == 3
        with open(os.path.join(d, n + "_metrics.csv")) as fh:
            rows = list(csv.reader(fh))
        assert rows[0] == metric_cols and len(rows) == 2
    # --only runs one leg
    assert list(mod.main(["--quick", "--device", "cpu", "--only",
                          names[-1]])) == [names[-1]]
