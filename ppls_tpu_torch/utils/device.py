"""Device selection and host-sync accounting for the port's entry
points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; without
    a card this raises instead of quietly running on the CPU, so a
    caller that wants the plain PyTorch path there says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    if dev.type == "cpu":
        _warm_cpu_exp()
    return dev


@functools.lru_cache(maxsize=None)
def _warm_cpu_exp() -> None:
    """One float64 ``torch.exp`` over every CPU worker thread, once per
    process. torch's CPU exp (2.13, AVX-512) can return values ~3.3e-9
    off in relative terms on the chunk a worker thread computes in its
    first call (``tests/test_torch_qmc.py``); later calls are right to
    the ulp. Entry points on the CPU pay this first call here, on values
    nobody reads."""
    n = 1 << 15                      # ATen's grain size
    torch.exp(torch.zeros(n * max(torch.get_num_threads(), 32),
                          dtype=torch.float64))


class HostSyncs:
    """Counts the points where the host loop reads a device value
    (``.item()`` / ``.tolist()``). The reference runs each phase as one
    compiled ``while_loop``; the port's host loop pays a device-to-host
    round trip at each of these points instead. The count is the same
    on the CPU, where the reads are free, so it describes the program,
    not the device it ran on."""

    def __init__(self) -> None:
        self.n = 0

    def pull(self, t: torch.Tensor):
        """``t.tolist()`` (a Python scalar for a 0-dim tensor), counted
        as one sync."""
        self.n += 1
        return t.tolist()

    def pull_arrays(self, *ts: torch.Tensor):
        """Host numpy copies of ``ts`` (never views of a live tensor),
        counted as one sync."""
        self.n += 1
        return tuple(t.to("cpu", copy=True).numpy() for t in ts)
