"""The one traffic generator: problems drawn from a traffic mix's
parameters and the run's seed.

A mix is a JSON file under ``traffic/``. Every draw comes from one
``numpy.random.Generator`` seeded by ``--seed`` (any integer, large ones
included) and by the stream's name, so the same seed gives the same
problems, and the warm-up, the window and the check draw from streams of
their own. Thetas are stratified: a batch of n covers ``[low, high)`` in
n equal strata, one jittered theta in each, in a shuffled order, so
every batch of a run, and of every seed, holds the same spread of
problem sizes.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of a run."""
    words = np.frombuffer(hashlib.sha256(
        f"{int(seed)}:{stream}".encode()).digest(), dtype=np.uint32)
    return np.random.default_rng(words)


def thetas(spec: dict, gen: np.random.Generator, n: int) -> np.ndarray:
    """n stratified thetas over ``[spec["low"], spec["high"])``."""
    lo, hi = float(spec["low"]), float(spec["high"])
    u = (np.arange(n) + gen.random(n)) / n
    return gen.permutation(lo + (hi - lo) * u)
