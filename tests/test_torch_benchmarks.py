"""The port's benchmark scripts of the last slice, and the stale-bin count,
run end to end on the CPU at a tiny size (their plain versions; the card
gives their numbers): each ``main`` prints and returns its JSON lines,
every line naming its device, with the keys and legs of its JAX script's
measurement."""
import json

import numpy as np
import pytest
import torch

from largesteps_torch.benchmarks import (micro_rebin, micro_scatter_163k,
                                         prof_suzanne_prebin, stage_times,
                                         stale_bins)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: beside the suite's other test
    processes, runs of many small tensor operations crawl on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STAGES = ["setup", "raster_fwd", "aa_fwd", "aa_bwd", "raster_bwd",
          "chain_scatter"]
CASES = {
    "micro_rebin": (micro_rebin, ["--subdiv", "2", "--views", "2", "--res",
                                  "128", "--cap", "256", "--reps", "1"],
                    ["bin_device_full_ms", "sort_per_camera_ms",
                     "sort_flat_ms"]),
    "micro_scatter_163k": (micro_scatter_163k,
                           ["--faces", "300", "--verts", "150", "--slots",
                            "2000", "--reps", "1"],
                           ["segsum_index_add_ms", "segsum_sorted_ms",
                            "segsum_presorted_ms", "gather_alone_ms",
                            "incidence_take_ms", "argsort_slots_ms"]),
    "stage_times_suzanne": (stage_times, ["suzanne", "--subdiv", "1",
                                          "--views", "2", "--res", "128",
                                          "--reps", "1"],
                            [f"{s}_ms" for s in STAGES]),
    "stage_times_nefertiti": (stage_times, ["nefertiti", "--subdiv", "2",
                                            "--views", "2", "--res", "128",
                                            "--reps", "1"],
                              [f"{s}_ms" for s in STAGES]),
    "prof_suzanne_prebin": (prof_suzanne_prebin,
                            ["--steps", "2", "--subdiv", "1", "--views", "1",
                             "--res", "128"],
                            [leg for leg, _ in prof_suzanne_prebin.LEGS]),
    # its second step moves past margin/2 (5.6 px) and is checked
    "stale_bins": (stale_bins, ["--subdiv", "1", "--target-subdiv", "2",
                                "--views", "2", "--res", "128", "--steps",
                                "2", "--checks", "1"],
                   ["check", "total"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_benchmark_main(name, capsys):
    mod, argv, legs = CASES[name]
    lines = mod.main([*argv, "--device", "cpu"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed == lines
    got = [line.get("metric", line.get("leg")) for line in lines]
    assert got == legs
    for line in lines:
        assert line["device"] == "cpu"
        if name == "stale_bins":
            continue
        vals = [line.get("value", line.get("it_per_s_sustained"))]
        assert all(np.isfinite(v) and v > 0 for v in vals)
    if name == "micro_scatter_163k":
        assert all(line["rel_err_vs_index_add"] <= 1e-6 for line in lines
                   if "rel_err_vs_index_add" in line)
    if name == "stale_bins":
        *checks, total = lines
        assert all(c["disp_px"] > c["margin_px"] / 2
                   and 0 <= c["differ"] <= c["pixels"]
                   and c["differ"] == c["uncovered_stale"]
                   + c["other_face_stale"] for c in checks)
        assert total["checks"] == len(checks) and total["differ_total"] \
            == sum(c["differ"] for c in checks)
    if name == "prof_suzanne_prebin":
        assert {"first_step_s", "rebin_n", "rebin_s", "loss_last"} \
            <= set(lines[0])
