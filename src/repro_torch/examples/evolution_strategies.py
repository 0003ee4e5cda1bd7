"""Evolution strategies (paper §5.3, Listings 6/10) with straggler
mitigation.

An Evolver holds a Gaussian search distribution over the parameters of a
small policy; Evaluators score samples in parallel, each on its torch
device (``--device``, the card unless ``cpu`` is asked for), via courier
``.futures`` (exactly the paper's pattern). Beyond the paper: the fan-out
uses ``lp.hedged_map`` — a generation completes on a quorum of evaluators,
so one slow/hung evaluator can't stall the loop (the 1000-node concern).

    PYTHONPATH=src python -m repro_torch.examples.evolution_strategies \
        --generations 30 --device cpu
"""

import numpy as np
import torch

from repro_torch import core as lp
from repro_torch.examples import _cli


def fitness_fn(params: np.ndarray, device) -> float:
    """Negative quadratic bowl around a hidden optimum (evaluated with
    torch on ``device``)."""
    x = torch.as_tensor(np.asarray(params, np.float32), device=device)
    target = torch.arange(x.shape[0], dtype=torch.float32,
                          device=device) / 10.0
    return float(-torch.sum((x - target) ** 2))


class Evaluator:
    def __init__(self, device="cuda"):
        self._device = _cli.checked_device(device)

    def evaluate(self, params):
        return fitness_fn(params, self._device)


class Evolver:
    def __init__(self, evaluators, dim=16, generations=30, sigma=0.3,
                 lr=0.2, quorum_frac=0.75, device="cuda"):
        self._device = _cli.checked_device(device)
        self._evaluators = evaluators
        self._dim = dim
        self._generations = generations
        self._sigma = sigma
        self._lr = lr
        self._quorum = max(2, int(quorum_frac * len(evaluators)))

    def run(self):
        rng = np.random.default_rng(0)
        mu = np.zeros(self._dim, np.float32)
        for g in range(self._generations):
            eps = rng.standard_normal((len(self._evaluators), self._dim))
            samples = mu + self._sigma * eps.astype(np.float32)
            calls = [
                (lambda ev=ev, s=s: ev.futures.evaluate(s))
                for ev, s in zip(self._evaluators, samples)]
            # Hedged fan-out: finish on a quorum, re-issue stragglers.
            fits = lp.hedged_map(calls, hedge_after_s=1.0,
                                 quorum=self._quorum, timeout_s=30.0)
            got = [(f, e) for f, e in zip(fits, eps) if f is not None]
            fs = np.array([f for f, _ in got], np.float32)
            es = np.stack([e for _, e in got]).astype(np.float32)
            adv = (fs - fs.mean()) / (fs.std() + 1e-8)
            grad = (adv[:, None] * es).mean(0) / self._sigma
            mu = mu + self._lr * self._sigma * grad
            if g % 5 == 0 or g == self._generations - 1:
                print(f"gen {g:3d}: mean fitness {fs.mean():8.4f} "
                      f"({len(got)}/{len(self._evaluators)} evaluators)")
        print(f"final fitness at mean: {fitness_fn(mu, self._device):.4f}")
        lp.stop_program()


def build(num_evaluators=6, generations=30, device="cuda") -> lp.Program:
    _cli.checked_device(device)
    p = lp.Program("es")
    with p.group("evaluator"):
        evaluators = [p.add_node(lp.CourierNode(Evaluator, device=device))
                      for _ in range(num_evaluators)]
    with p.group("evolver"):
        p.add_node(lp.CourierNode(Evolver, evaluators,
                                  generations=generations, device=device))
    return p


def main(argv=None):
    ap = _cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--evaluators", type=int, default=6)
    ap.add_argument("--generations", type=int, default=30)
    args = ap.parse_args(argv)
    lp.launch_and_wait(build(args.evaluators, args.generations,
                             device=args.device),
                       timeout_s=300)


if __name__ == "__main__":
    main()
