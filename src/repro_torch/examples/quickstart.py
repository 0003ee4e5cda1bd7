"""Quickstart: the paper's Figure-1 producer-consumer program, verbatim
structure (Listing 2), on the thread launcher. Nothing here computes on a
device; ``--device`` is checked as in every example.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from repro_torch import core as lp
from repro_torch.examples import _cli


class Range:
    """Produces sequential data on request from a given range."""

    def __init__(self, lo: int, hi: int):
        self._lo, self._hi = lo, hi

    def get(self):
        return list(range(self._lo, self._hi))


class Consumer:
    """Performs some calculation on the producers' outputs."""

    def __init__(self, producers):
        self._producers = producers

    def run(self):
        values = [p.get() for p in self._producers]
        total = sum(sum(v) for v in values)
        print(f"consumer received {values} -> total {total}")
        lp.stop_program()


def make_program() -> lp.Program:
    # Create an empty program graph.
    p = lp.Program("producer-consumer")

    # Add nodes producing a range of data.
    with p.group("producer"):
        r1 = p.add_node(lp.CourierNode(Range, 0, 10))
        r2 = p.add_node(lp.CourierNode(Range, 10, 20))

    # Add a node to consume from producers.
    with p.group("consumer"):
        p.add_node(lp.CourierNode(Consumer, [r1, r2]))
    return p


def main(argv=None):
    ap = _cli.parser(__doc__.splitlines()[0])
    _cli.checked_device(ap.parse_args(argv).device)
    program = make_program()
    print(program)
    lp.launch_and_wait(program, timeout_s=30)
    print("done.")


if __name__ == "__main__":
    main()
