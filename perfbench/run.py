"""Run one cell of the port's benchmark once.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

A cell (``workloads/<NAME>.json``) names a configuration
(``configs/<config>.json``: the scene and the experiment's driver
parameters) and a traffic mix (``traffic/<traffic>.json``: the leg's own
parameters, the views, the warm-up and the traced steps).  The run:

1. makes the scene from ``--seed`` (``scene.py``) and calls the program's
   ``largesteps_torch.driver.optimize_shape`` on the card for a short
   warm-up (lazy loads, the kernels' build);
2. calls it again for ``--seconds`` times the traffic's ``rate`` steps
   (about ``--seconds`` of card time when the cell was made): the window, from the first step's start to the last step's
   completion, every step's completion an event recorded by the optimizer
   wrapper :class:`Probe` (no host wait in the loop);
3. compares what the window's call produced with the plain reference
   (``check.py``) and prints each number beside its limit on standard
   error and under ``checks`` in the result line;
4. with ``--trace 1`` profiles a bounded run of the window's steps and
   reads each per-layer metric by its reader (``metrics/<name>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``.  Without a card it exits 2 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, reference, scene as scenes, trace as tracing  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "largesteps_tpu")
GIB = float(1 << 30)


def find(kind: str, name: str, roots=(HERE,)) -> str:
    """The path of ``<root>/<kind>/<name>.json`` (``.py`` for metrics) in
    the first root that has it."""
    ext = ".py" if kind == "metrics" else ".json"
    for root in roots:
        path = os.path.join(root, kind, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind[:-1]} named {name!r}")


def load(kind: str, name: str, roots=(HERE,)) -> dict:
    with open(find(kind, name, roots)) as fh:
        return json.load(fh)


def reader(name: str, roots=(HERE,)):
    """The ``read(ctx)`` function of the per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        find("metrics", name, roots))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """Marks on the card's stream (CUDA events) or, on the CPU, where work
    is done when its call returns, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b) * 1e-3
        return b - a


class Probe:
    """The program's own optimizer behind the two calls the driver makes a
    step: ``zero_grad`` (the step's start) and ``step`` (its update).  It
    marks the window's start and each step's completion, keeps copies of
    the parameters and gradients the comparison needs at the steps named
    in ``keep_theta`` and ``keep_grad``, and runs ``on_start(k)`` at each
    step's start (the profiler's bounds)."""

    def __init__(self, inner, params, clock, keep_theta=(), keep_grad=(),
                 on_start=None):
        self.inner, self.params, self.clock = inner, params, clock
        self.keep_theta, self.keep_grad = set(keep_theta), set(keep_grad)
        self.on_start = on_start
        self.k = 0
        self.t_first = None
        self.marks = []
        self.theta, self.grad = {}, {}

    def _named(self, xs):
        return {"tr": xs[0].detach().clone(), "u": xs[1].detach().clone()}

    def zero_grad(self, set_to_none=True):
        if self.k == 0:
            self.t_first = time.perf_counter()
            self.marks.append(self.clock.mark())
        if self.on_start is not None:
            self.on_start(self.k)
        if self.k in self.keep_theta:
            self.theta[self.k] = self._named(self.params)
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        if self.k in self.keep_grad:
            self.grad[self.k] = self._named([p.grad for p in self.params])
        self.inner.step()
        self.marks.append(self.clock.mark())
        self.k += 1


class Tracer:
    """``torch.profiler`` over the steps [first, first + steps) of the
    window, started and stopped with the card drained; each step's start
    is a host range ``perfbench.step``."""

    def __init__(self, first, steps, path):
        self.first, self.last, self.path = first, first + steps, path
        self.prof = None
        self.marks = {}

    def __call__(self, k):
        from torch.profiler import ProfilerActivity, profile
        if k == self.first:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        if k == self.last and self.prof is not None:
            torch.cuda.synchronize()
            self.prof.stop()
            self.prof.export_chrome_trace(self.path)
            self.prof = None
        if self.first <= k < self.last:
            self.marks[k] = time.perf_counter()
            with torch.profiler.record_function(f"perfbench.step.{k}"):
                pass


def optimizer_factory(name, make_probe):
    """The driver's optimizer callable: the program's own optimizer of
    that name, wrapped in a :class:`Probe`."""
    from largesteps_torch.core.optimize import Adam, AdamUniform
    kinds = {"AdamUniform": AdamUniform, "Adam": Adam}

    def build(params, lr):
        return make_probe(kinds[name](params, lr=lr), params)

    return build


def cell(workload: str, roots=(HERE,)) -> tuple:
    wl = load("workloads", workload, roots)
    cfg = load("configs", wl["config"], roots)
    tr = load("traffic", wl["traffic"], roots)
    params = {**cfg["params"], **tr["params"]}
    return wl, cfg, tr, params


def has_card(chips: int) -> bool:
    return torch.cuda.is_available() and torch.cuda.device_count() >= chips


def timed_call(optimize_shape, scn, params, device, n_steps, probe_kw):
    """One call of ``optimize_shape`` for ``n_steps`` steps under a
    :class:`Probe`; returns (result, probe)."""
    clock = Clock(device)
    box = {}

    def make(inner, ps):
        box["probe"] = Probe(inner, ps, clock, **probe_kw)
        return box["probe"]

    p = dict(params, steps=int(n_steps),
             optimizer=optimizer_factory(params["optimizer"], make))
    result = optimize_shape(scn, p, device=device)
    return result, box["probe"]


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def per_layer_of(name: str, bench_file: str = BENCHMARK) -> list:
    """The per-layer metrics of ``BENCHMARK.json`` that cell ``name``
    reports: those that list it, and those that list no cells."""
    with open(bench_file) as fh:
        bench = json.load(fh)
    return [m for m in bench.get("per_layer", [])
            if name in m.get("workloads", [name])]


def run(args, roots=(HERE,), device="cuda", require_card=True, plant=None,
        bench_file=BENCHMARK, keep=None):
    """One run; returns (exit code, result dict or None)."""
    wl, cfg, tr, params = cell(args.workload, roots)
    if require_card and not has_card(int(wl["chips"])):
        print(f"perfbench: the cell needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2, None
    os.environ.setdefault("USE_FLAX", "0")
    parts = {}
    from largesteps_torch.driver import optimize_shape
    if plant is not None:
        plant()
    parts["imports_s"] = time.perf_counter() - T_START
    t0 = time.perf_counter()
    scn = scenes.scene_for(cfg["scene"], int(tr["views"]), args.seed)
    parts["scene_s"] = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    process_peak = 0

    # warm-up: the first call pays lazy loads and builds; its second half's
    # step rate is printed
    t0 = time.perf_counter()
    warm_n = int(tr["warmup_steps"])
    res, probe = timed_call(optimize_shape, scn, params, device, warm_n, {})
    half = warm_n // 2
    rate = (warm_n - half) / max(
        probe.clock.seconds(probe.marks[half], probe.marks[-1]), 1e-9)
    parts["warmup_s"] = time.perf_counter() - t0
    parts["warmup_epoch_s"] = res["prof"]["setup_s"]
    del res, probe
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        process_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    # a fixed amount of work for a given --seconds: the traffic's step rate
    # (measured on the card when the cell was made), not this run's
    n = max(int(tr["min_steps"]), int(round(args.seconds * tr["rate"])))
    keep_theta = {0, 1, check.FOLLOW, n - 1}
    tracer = None
    tmp = None
    if args.trace:
        first = min(int(tr["trace_start"]), max(n - int(tr["trace_steps"]),
                                                2))
        steps = min(int(tr["trace_steps"]), n - 1 - first)
        tmp = tempfile.mkdtemp(prefix="perfbench_")
        if cuda:
            tracer = Tracer(first, steps, os.path.join(tmp, "trace.json"))
        keep_theta |= set(range(first, first + steps))
    t_call = time.perf_counter()
    res, probe = timed_call(optimize_shape, scn, params, device, n, {
        "keep_theta": keep_theta, "keep_grad": {0, n - 1},
        "on_start": tracer})
    if cuda:
        torch.cuda.synchronize()
    parts["epoch_s"] = res["prof"]["setup_s"]
    clock = probe.clock
    window_s = clock.seconds(probe.marks[0], probe.marks[-1])
    intervals = [clock.seconds(a, b) for a, b in zip(probe.marks,
                                                     probe.marks[1:])]
    setup_s = probe.t_first - T_START
    losses = np.asarray(res["losses"], np.float64)
    failed = int((~np.isfinite(losses).all(axis=1)).sum()) \
        + max(0, n - len(losses))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    if not args.trace:
        metrics = {
            "steps_per_s": {"value": n / window_s, "unit": "steps/s"},
            "step_ms_p95": {"value": percentile(intervals, 95) * 1e3,
                            "unit": "ms"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    print(json.dumps({"setup_parts_s": parts, "steps": n,
                      "warmup_rate": rate, "window_s": window_s,
                      "step_ms_p50": percentile(intervals, 50) * 1e3,
                      "rebins": res["prof"].get("rebin_n"),
                      "call_s": time.perf_counter() - t_call}), flush=True)

    prof = res["prof"]
    v_losses = losses[:, 0].tolist()
    out = {"losses": v_losses, "grad0": probe.grad[0],
           "theta0": probe.theta[0], "theta1": probe.theta[1],
           "theta3": probe.theta[check.FOLLOW],
           "loss_last": v_losses[-1], "grad_last": probe.grad[n - 1]}
    theta_last = probe.theta[n - 1]
    traced = {k: probe.theta[k] for k in probe.theta
              if tracer is not None and tracer.first <= k < tracer.last}
    marks = dict(tracer.marks) if tracer is not None else {}
    del res, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, after the window and with the program's state freed
    ref = reference.Reference(scn, params, device)
    ref_out = check.side_outputs(ref, theta_last)
    nums = check.numbers(out, ref_out, ref)
    if keep is not None:
        keep.update(scene=scn, params=params, theta_last=theta_last,
                    ref_out=ref_out, numbers=nums, out=out, prof=prof)
    limits = wl["limits"]
    correct = check.judge(nums, limits) and failed == 0
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in
              check.NUMBERS}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(peak, process_peak))
                   if cuda else 0}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        per_layer, extra = read_trace(
            per_layer_of(args.workload, bench_file), wl, tr, roots, ref,
            tmp, tracer, marks, traced, prof, n)
        result["metrics"] = per_layer
        result["device"].update(extra["device"])
        if extra.get("breakdown"):
            result["breakdown"] = extra["breakdown"]
    if tmp:
        shutil.rmtree(tmp, ignore_errors=True)
    result["checks"] = checks
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3, None
    return 0, result


def read_trace(wanted, wl, tr, roots, ref, tmp, tracer, marks, traced, prof,
               n):
    """The per-layer metrics of the traced steps, the device's busy and
    window seconds, and the breakdown."""
    ctx = {"workload": wl, "traffic": tr, "prof": prof, "steps": n,
           "trace_first": None, "trace_last": None, "summary": None,
           "work": [], "busy_s": None, "window_s": None}
    extra = {"device": {}}
    path = os.path.join(tmp, "trace.json")
    if tracer is not None and os.path.isfile(path):
        with open(path) as fh:
            full = json.load(fh)
        os.remove(path)
        # the first two traced steps are left out: the card is refilling
        # its queue after the profiler's start
        skip = tracer.first + 2
        lo = [e["ts"] for e in full.get("traceEvents", [])
              if e.get("name") == f"perfbench.step.{skip}"]
        cut = tracing.window(full, min(lo)) if lo else full
        counted = tracer.last - skip
        busy_us, win_us, merged = tracing.busy(full, cut)
        wall = marks[tracer.last - 1] - marks[skip] if counted > 1 else 0.0
        ctx.update(summary=tracing.summarize(cut, counted, max(wall, 1e-9)),
                   trace_first=skip, trace_last=tracer.last,
                   busy_s=busy_us * 1e-6, window_s=win_us * 1e-6)
        extra["device"] = {"busy_s": busy_us * 1e-6,
                           "window_s": win_us * 1e-6}
        extra["breakdown"] = tracing.breakdown(full, cut, merged)
        del full, cut
        for k in range(skip, tracer.last):
            th = traced[k]
            ctx["work"].append(reference.count_work(ref, th["u"], th["tr"]))
    per_layer = {}
    for m in wanted:
        value = reader(m["name"], roots)(ctx)
        if value is not None:
            per_layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return per_layer, extra


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, **kw):
    args = parse(argv)
    code, result = run(args, **kw)
    if result is not None:
        for k, c in result["checks"].items():
            lim = "none: read, not compared" if c["limit"] is None \
                else f"{c['limit']:.6g}"
            print(f"check {k}: {c['value']:.6g} (limit {lim})",
                  file=sys.stderr)
        print(f"correct: {result['correct']}", file=sys.stderr)
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
