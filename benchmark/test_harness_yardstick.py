"""The yardstick: the generator, the roofline arithmetic, the trace
reduction's interval arithmetic, the reference against itself and the
control against the check's limit. CPU only; the last test needs a card
and skips without one."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import devtrace  # noqa: E402
import generate  # noqa: E402
import reference  # noqa: E402
import roofline  # noqa: E402


def test_generator_is_deterministic_per_seed():
    spec = {"low": 1.0, "high": 2.0}
    big = 2 ** 31 + 12345
    a = generate.thetas(spec, generate.rng(big, "window"), 64)
    b = generate.thetas(spec, generate.rng(big, "window"), 64)
    c = generate.thetas(spec, generate.rng(big + 1, "window"), 64)
    d = generate.thetas(spec, generate.rng(big, "warm"), 64)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    # stratified: one theta in each of the 64 strata
    assert np.array_equal(np.sort(np.floor((a - 1.0) * 64)), np.arange(64))
    from drivers.stream import requests
    mix = {"theta": spec, "thetas_per_request": 8, "block": 4}
    r1, r2, r3 = (requests(mix, s) for s in (big, big, big + 1))
    for _ in range(3):
        a, b, c = ([next(r) for _ in range(4)] for r in (r1, r2, r3))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        # another seed: the same requests of the block, in its own order
        assert not all(np.array_equal(x, y) for x, y in zip(a, c))
        assert sorted(np.sort(x).tolist() for x in a) == sorted(
            np.sort(x).tolist() for x in c)


def test_traffic_mixes_load():
    for name in os.listdir(os.path.join(HERE, "traffic")):
        mix = generate.load_mix(name[:-5])
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           f"{mix['driver']}.py"))


def test_roofline_arithmetic_on_fixed_counts():
    data = {"peaks": {"f32_ops_per_s": 1e12, "bytes_per_s": 1e9},
            "ops_per_eval": {"fam": {"ds_eval": 300, "scout_eval": 30,
                                     "step_overhead": 100}},
            "k1_bytes": {"lane_in": 10, "lane_out": 6,
                         "bank_in_per_slot": 3, "bank_out_per_slot": 1,
                         "fixed_out": 4}}
    # plain: 1e6 live steps x 400 operations at 1e12/s = 4e-4 s
    t = roofline.k1_least_seconds(data, "fam", live_steps=10 ** 6,
                                  scout_evals=0, confirm_evals=0,
                                  launches=1, lanes=100, refill_slots=2)
    assert t == pytest.approx(4e-4)
    # scouting: 1e6 x 30 + 2e5 x 300 + 1e6 x 100 = 1.9e8 operations
    t = roofline.k1_least_seconds(data, "fam", live_steps=10 ** 6,
                                  scout_evals=10 ** 6,
                                  confirm_evals=2 * 10 ** 5, launches=1,
                                  lanes=100, refill_slots=2)
    assert t == pytest.approx(1.9e-4)
    # bytes bound: 1e3 launches x (100 x 16 + 100 x 2 x 4 + 4) bytes
    t = roofline.k1_least_seconds(data, "fam", live_steps=1,
                                  scout_evals=0, confirm_evals=0,
                                  launches=1000, lanes=100, refill_slots=2)
    assert t == pytest.approx(1000 * 2404 / 1e9)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
    trace = {"kernel_s": {"walk_rf_kernel<0>": 2.0, "other": 1.0}}
    assert roofline.kernel_seconds(trace, "walk_rf_kernel") == 2.0
    assert roofline.kernel_seconds(None, "walk_rf_kernel") == 0.0


def test_frozen_counts_are_the_flagship_family():
    ops = roofline.load()["ops_per_eval"]["sin_recip_scaled"]
    assert (ops["ds_eval"], ops["scout_eval"], ops["step_overhead"]) == \
        (330, 33, 171)


def test_union_and_gap_naming():
    assert devtrace._union([(5, 7), (0, 2), (1, 3), (6, 9)]) == \
        [[0, 3], [5, 9]]
    host = [(0, 100, "outer", True), (10, 20, "aten::mul", False),
            (12, 14, "cudaLaunchKernel", False), (40, 60, "aten::add", False)]
    named = devtrace._name_gaps([(12, 14), (45, 55), (80, 90), (200, 210)],
                                host)
    assert named == {"outer___cudaLaunchKernel": 2, "outer___aten::add": 10,
                     "outer": 10, "host": 10}


def test_reference_bag_matches_a_plain_loop():
    f = reference.load_integrand("sin_recip_scaled")

    def loop(theta, a, b, eps):
        import math
        stack, area = [(a, b)], 0.0
        while stack:
            l, r = stack.pop()
            m = (l + r) * 0.5
            fl, fr, fm = (math.sin(theta / x) for x in (l, r, m))
            whole = (fl + fr) * ((r - l) * 0.5)
            halves = (fl + fm) * ((m - l) * 0.5) + (fm + fr) * ((r - m)
                                                                * 0.5)
            if abs(halves - whole) > eps:
                stack += [(l, m), (m, r)]
            else:
                area += halves
        return area

    import torch
    th = torch.tensor([1.0, 1.5, 1.9], dtype=torch.float64)
    got = reference.bag_areas(f, th, (1e-2, 1.0), 1e-7)["areas"]
    want = [loop(float(t), 1e-2, 1.0, 1e-7) for t in th]
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_control_fails_the_check_and_the_reference_passes():
    import torch

    import check
    import control
    import harness

    manifest = harness.load_manifest()
    for cell in manifest["workloads"]:
        cfg = harness.load_config(manifest, cell["config"])
        mix = dict(generate.load_mix(cell["traffic"]), check_answers=32)
        rec = control.problems(cfg, mix, 2 ** 31 + 7, 2 if mix["driver"]
                               == "family" else 8)
        ctl = check.run(cfg, mix, rec, 2 ** 31 + 7, "cpu",
                        answer_dtype=torch.float32)
        assert not ctl["correct"], cell["name"]
        assert ctl["numbers"]["area_gap"]["value"] > 10 * cfg[
            "area_gap_limit"]
        ref = check.run(cfg, mix, rec, 2 ** 31 + 7, "cpu",
                        answer_dtype=torch.float64)
        assert ref["correct"] and ref["numbers"]["area_gap"]["value"] == 0


@pytest.mark.cuda
def test_control_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control
    assert control.main(["--workload", "flagship.family", "--seeds", "1",
                         "--calls", "2"]) == 0
