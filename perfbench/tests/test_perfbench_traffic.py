"""The traffic generator: repeatable per seed, the same work for every
seed, lengths clipped to the mix's range and fitted to its trace."""

import numpy as np

from perfbench import spec
from perfbench import traffic as tr

MIX = spec.load_json(f"{spec.HERE}/traffic/chat-backlog.json")


def test_schedule_repeats_for_a_seed_and_differs_across_seeds():
    pa, oa = tr.lengths(MIX, 2 ** 31 + 17, 200)
    pb, ob = tr.lengths(MIX, 2 ** 31 + 17, 200)
    pc, oc = tr.lengths(MIX, 2 ** 31 + 18, 200)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(oa, ob)
    assert not np.array_equal(pa, pc)
    np.testing.assert_array_equal(tr.prompt(1000, 7, 5, 2),
                                  tr.prompt(1000, 7, 5, 2))
    assert not np.array_equal(tr.prompt(1000, 7, 5, 2),
                              tr.prompt(1000, 7, 5, 3))


def test_every_seed_gets_the_same_work_in_another_order():
    p1, o1 = tr.lengths(MIX, 1, 256, block=128)
    p2, o2 = tr.lengths(MIX, 2, 256, block=128)
    np.testing.assert_array_equal(np.sort(p1[:128]), np.sort(p2[:128]))
    np.testing.assert_array_equal(np.sort(o1[128:]), np.sort(o2[128:]))


def test_lengths_are_clipped_to_the_mix_range():
    p, o = tr.lengths(MIX, 3, 1000)
    assert p.min() >= 64 and p.max() == 2048
    assert o.min() == 16 and o.max() == 512
    q = tr.quantiles({"dist": "lognormal", "median": 512, "sigma": 0.8,
                      "min": 64, "max": 2048}, 101)
    assert q[50] == 512
    assert (q == np.sort(q)).all()
    assert (tr.quantiles({"dist": "fixed", "value": 7}, 4) == 7).all()


def test_the_chat_mix_has_its_trace_medians_and_means():
    """Azure's 2023 conversation trace: medians 1020 and 129 tokens,
    means 1155 and 211, before the clip to the engine's context."""
    for dist, median, mean in ((MIX["prompt"], 1020, 1155),
                               (MIX["output"], 129, 211)):
        q = tr.quantiles(dict(dist, min=1, max=10 ** 9), 20001)
        assert q[10000] == median
        assert abs(q.mean() / mean - 1) < 0.02
