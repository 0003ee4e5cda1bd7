"""Generated tokens of the requests completed inside the window, over
the window's seconds."""

from perfbench import stats


def read(b):
    done = b.done_in_window()
    if not done:
        return None
    return stats.rate(sum(r["out_len"] for r in done), b.t0, b.t1)
