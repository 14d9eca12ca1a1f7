"""sin(theta / x): the flagship family, in plain PyTorch.

``f(x, theta)`` broadcasts an interval column ``x`` against a theta
table, in whatever floating type the arguments carry.
"""

import torch


def f(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return torch.sin(theta / x)
