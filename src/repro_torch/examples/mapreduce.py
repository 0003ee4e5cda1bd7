"""MapReduce word count (paper §5.2, Listings 5/9).

One WordMapper node per input file, hash-partitioned over CountReducer
nodes; reducers append their counts to the output file when the last
mapper finishes. Nothing here computes on a device; ``--device`` is
checked as in every example.

    PYTHONPATH=src python -m repro_torch.examples.mapreduce --device cpu
"""

import os
import tempfile
import threading

from repro_torch import core as lp
from repro_torch.examples import _cli


class WordMapper:
    def __init__(self, infile_path, reducers):
        self._infile_path = infile_path
        self._reducers = reducers

    def run(self):
        for reducer in self._reducers:
            reducer.mapper_begin()
        with open(self._infile_path) as f:
            for line in f:
                for word in line.split():
                    self._send_word(word)
        for reducer in self._reducers:
            reducer.mapper_done()

    def _send_word(self, word):
        n = len(self._reducers)
        idx = hash(word) % n
        self._reducers[idx].reduce(word, 1)


class CountReducer:
    def __init__(self, outfile_path, num_mappers):
        self._remaining = num_mappers
        self._counter = {}
        self._lock = threading.Lock()
        self._outfile_path = outfile_path

    def reduce(self, key, value):
        with self._lock:
            self._counter[key] = self._counter.get(key, 0) + value

    def mapper_begin(self):
        pass

    def mapper_done(self):
        # Flush exactly once, when the LAST mapper reports done. (The
        # paper's sketch decrements an "active" counter, which can flush
        # early if a fast mapper finishes before a slow one begins.)
        with self._lock:
            self._remaining -= 1
            if self._remaining == 0:
                self._done()

    def _done(self):
        with open(self._outfile_path, "a") as f:
            for key, count in sorted(self._counter.items()):
                f.write(f"{key} {count}\n")


class Waiter:
    """Stops the program when every reducer has flushed."""

    def __init__(self, reducers, out_path, expected_total):
        self._reducers = reducers
        self._out = out_path
        self._expected = expected_total

    def run(self):
        ctx = lp.get_current_context()
        while not ctx.should_stop:
            if os.path.exists(self._out):
                with open(self._out) as f:
                    total = sum(int(l.split()[1]) for l in f if l.strip())
                if total >= self._expected:
                    print(f"word total: {total} (expected {self._expected})")
                    lp.stop_program()
                    return
            ctx.wait_for_stop(0.05)


def build(in_paths, out_path, expected_total, num_reducers=3) -> lp.Program:
    p = lp.Program("mapreduce")
    reducers = []
    with p.group("reducer"):
        for _ in range(num_reducers):
            reducers.append(p.add_node(lp.CourierNode(
                CountReducer, out_path, len(in_paths))))
    with p.group("mapper"):
        for path in in_paths:
            p.add_node(lp.CourierNode(WordMapper, path, reducers))
    p.add_node(lp.CourierNode(Waiter, reducers, out_path, expected_total))
    return p


def main(argv=None):
    ap = _cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--files", nargs="*", default=None)
    args = ap.parse_args(argv)
    _cli.checked_device(args.device)

    tmp = None
    if args.files:
        in_paths = args.files
        expected = None
    else:
        tmp = tempfile.mkdtemp()
        texts = ["the quick brown fox jumps over the lazy dog\n" * 20,
                 "pack my box with five dozen liquor jugs\n" * 30]
        in_paths = []
        expected = sum(len(t.split()) for t in texts)
        for i, t in enumerate(texts):
            path = os.path.join(tmp, f"in{i}.txt")
            with open(path, "w") as f:
                f.write(t)
            in_paths.append(path)

    out_path = os.path.join(tmp or ".", "wordcount.txt")
    if os.path.exists(out_path):
        os.remove(out_path)
    program = build(in_paths, out_path, expected or 1)
    lp.launch_and_wait(program, timeout_s=60)
    with open(out_path) as f:
        lines = f.readlines()
    print(f"{len(lines)} distinct words -> {out_path}")


if __name__ == "__main__":
    main()
