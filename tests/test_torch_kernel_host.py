"""K1's own arithmetic, checked on the CPU: the step machine of
``csrc/walk_step.cuh`` (the code the CUDA kernel runs per lane), built
with g++ -O2 -ffp-contract=off into a host library with a plain
sequential loop (``csrc/walk_host.cpp``), held bit for bit against the
plain PyTorch segment on the same seeded lanes, launch after launch, in
both step modes and for both kernel integrands.

The ``cuda`` tests hold the CUDA kernel itself against the plain
segment, and the walker on the card against the walker on the CPU; they
skip where there is no card. This file imports nothing of JAX, so on a
machine without it the card tests run with
``python -m pytest --noconftest tests/test_torch_kernel_host.py -m cuda``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.parallel import walker as W

CASES = [
    ("sin_recip_scaled", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0), 1e-7),
    ("cosh4_scaled", 0.5 + np.arange(4) / 4.0, (0.0, 3.0), 1e-6),
]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the K1 step "
                    "machine cannot be made")
    from ppls_tpu_torch.utils.cuda_build import build_walk_host
    return build_walk_host(tmp_path_factory.mktemp("walk_host")).lib


def _inputs(fam, theta, bounds, eps, scout, device="cpu"):
    return W.first_phase_inputs(
        get_family(fam), theta, bounds, eps, lanes=256, roots_per_lane=4,
        refill_slots=4, capacity=1 << 16, scout=scout, min_active_frac=0.05,
        device=device)


def _clone(inp):
    out = dict(inp)
    out["state"] = W.WalkState(*(t.clone() for t in inp["state"]))
    for k in ("slot", "nslots"):
        out[k] = inp[k].clone()
    for k in ("bank", "resm"):
        out[k] = tuple(t.clone() for t in inp[k])
    return out


def _run_host(lib, inp, cap, f_ds, eps, scout):
    R, lanes = inp["bank"][0].shape
    resh = torch.zeros((R, lanes), dtype=torch.float32)
    resl = torch.zeros((R, lanes), dtype=torch.float32)
    ctr = torch.zeros(8, dtype=torch.int32)
    sync = torch.zeros(6, dtype=torch.int32)
    ops = (*inp["state"], inp["nslots"], inp["slot"], *inp["bank"],
           *inp["resm"], resh, resl, ctr, sync)
    table = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    rc = lib.walk_rf_host(ctypes.cast(table, ctypes.c_void_p), lanes, R,
                          f_ds.kernel_family, int(scout), f32(eps),
                          inp["thresh"], cap, inp["batch"])
    assert rc == 0
    return resh, resl, ctr


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(a, b, outs_a, outs_b):
    for name, x, y in zip(W.WalkState._fields, a["state"], b["state"]):
        assert torch.equal(_bits(x), _bits(y)), name
    assert torch.equal(a["slot"], b["slot"])
    for x, y in zip(a["resm"], b["resm"]):
        assert torch.equal(_bits(x), _bits(y))
    for x, y in zip(outs_a, outs_b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("fam,theta,bounds,eps", CASES)
def test_host_step_machine_bit_equal_to_plain_segment(host_lib, fam, theta,
                                                      bounds, eps, scout):
    f_ds = get_family_ds(fam)
    base = _inputs(fam, theta, bounds, eps, scout)
    a, b = _clone(base), _clone(base)
    steps = 0
    for cap in (24, 24, 64):          # consecutive launches on one state
        outs_a = W.segment_rf_plain(a["state"], a["slot"], a["thresh"], cap,
                                    a["batch"], a["nslots"], a["bank"],
                                    a["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout)
        outs_b = _run_host(host_lib, b, cap, f_ds, eps, scout)
        _assert_bit_equal(a, b, outs_a, outs_b)
        steps += int(outs_a[2][0])
    assert steps > 24
    assert int(a["slot"].sum()) > 256       # refills happened


def test_k1_wrapper_on_cpu_is_the_plain_segment():
    f_ds = get_family_ds("sin_recip_scaled")
    base = _inputs(*CASES[0], scout=True)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_rf.launches
    outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], 16,
                              a["batch"], a["nslots"], a["bank"], a["resm"],
                              f_ds=f_ds, eps=1e-7, scout=True)
    outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], 16,
                                b["batch"], b["nslots"], b["bank"],
                                b["resm"], f_ds=f_ds, eps=1e-7, scout=True)
    _assert_bit_equal(a, b, outs_a, outs_b)
    assert W.run_segment_rf.launches == before   # no kernel launched


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_kernel_host.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scout", [False, True])
def test_cuda_kernel_bit_equal_to_plain_segment(cuda_device, scout):
    fam, theta, bounds, eps = CASES[0]
    f_ds = get_family_ds(fam)
    base = _inputs(fam, theta, bounds, eps, scout, device=cuda_device)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_rf.launches
    for cap in (24, 64):
        outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], cap,
                                  a["batch"], a["nslots"], a["bank"],
                                  a["resm"], f_ds=f_ds, eps=eps, scout=scout)
        outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], cap,
                                    b["batch"], b["nslots"], b["bank"],
                                    b["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout)
        torch.cuda.synchronize()
        _assert_bit_equal(a, b, outs_a, outs_b)
    assert W.run_segment_rf.launches == before + 2


@pytest.mark.cuda
def test_cuda_walker_matches_cpu_walker(cuda_device):
    # the whole slice on the card (K1) and on the CPU (plain segment):
    # the same decisions, so the same task count, and areas equal up to
    # the float64 reduction order of the two devices
    fam, theta, bounds, eps = CASES[0]
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05,
              scout_dtype="f32", double_buffer=True)
    before = W.run_segment_rf.launches
    gpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device=cuda_device,
                                    **kw)
    assert W.run_segment_rf.launches > before
    cpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device="cpu", **kw)
    assert gpu.metrics.tasks == cpu.metrics.tasks
    assert gpu.kernel_steps == cpu.kernel_steps
    assert np.array_equal(gpu.waste, cpu.waste)
    assert np.max(np.abs(gpu.areas - cpu.areas)) < 1e-12
