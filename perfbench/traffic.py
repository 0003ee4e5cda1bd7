"""The one traffic generator: every mix under ``traffic/`` is parameters
for it.

Every seed gets the same multiset of sizes, in its own order: lengths
are quantiles of the mix's distributions at evenly spaced levels, and
the seed permutes them. So two seeds ask for the same work, and runs
differ by the order and by the prompt tokens, which are uniform over the
vocabulary. A length
distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "fixed", "value"}``."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the levels (i + 1/2) / n of ``dist``, clipped to
    its range, as int64."""
    if dist["dist"] == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = NormalDist()
    levels = [(i + 0.5) / n for i in range(n)]
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    xs = np.array([math.exp(mu + sigma * nd.inv_cdf(u)) for u in levels])
    return np.clip(np.rint(xs), dist["min"], dist["max"]).astype(np.int64)


def lengths(mix: dict, seed: int, n: int, block: int | None = None
            ) -> tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths) of ``n`` requests. With
    ``block``, each run of ``block`` requests holds the same multiset, so
    any prefix of the stream is near the mix."""
    block = block or n
    rng = _rng(seed, 1)
    p_q, o_q = quantiles(mix["prompt"], block), quantiles(mix["output"],
                                                          block)
    ps, os_ = [], []
    for _ in range(-(-n // block)):
        ps.append(p_q[rng.permutation(block)])
        # Output lengths are permuted apart from prompt lengths: the two
        # are independent in the mix.
        os_.append(o_q[rng.permutation(block)])
    return np.concatenate(ps)[:n], np.concatenate(os_)[:n]


def prompt(vocab: int, length: int, seed: int, i: int) -> np.ndarray:
    """Request ``i``'s prompt: ``length`` tokens uniform over the
    vocabulary, its own stream of the seed (so a backlog can draw
    prompts as it goes), unshared with any other request's."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 3, int(i)])
    return rng.integers(0, vocab, int(length), dtype=np.int32)
