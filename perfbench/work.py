"""The work each engine call did, rebuilt from the program's spans and
the requests the load sent: for every decode window, each row's
positions, and for every prefill call, its offset and length. The
readers of the kernels' and the model's shares count operations and
bytes from these with the architecture's counts
(``archs/<name>.py``)."""

from __future__ import annotations


def _requests_by_trace(bundle) -> dict:
    return {r["trace_id"]: r for r in bundle.requests if r.get("trace_id")}


def decode_rows(bundle) -> list[tuple[float, float, list[int]]]:
    """[(wall start, wall end, positions)]: one entry per request and
    decode window, with the positions of the steps whose tokens the
    request kept (a step at position t reads t + 1 keys)."""
    reqs = _requests_by_trace(bundle)
    out = []
    for trace_id, spans in bundle.by_trace().items():
        r = reqs.get(trace_id)
        if r is None:
            continue
        t, made = r["prompt_len"], 1       # the first token came from prefill
        for sp in sorted((s for s in spans if s["name"] == "decode"),
                         key=lambda s: s["ts"]):
            k = int(sp["attrs"].get("k", 1))
            used = max(0, min(k, r["max_new"] - made))
            out.append((sp["ts"], sp["ts"] + sp["dur"],
                        list(range(t, t + used))))
            t, made = t + used, made + used
    return out


def prefill_calls(bundle) -> list[tuple[float, float, int, int, str]]:
    """[(wall start, wall end, offset, tokens, path)]: one per prefill
    call (a whole prompt, its suffix after a prefix-cache hit, or one
    chunk)."""
    reqs = _requests_by_trace(bundle)
    out = []
    for trace_id, spans in bundle.by_trace().items():
        r = reqs.get(trace_id)
        if r is None:
            continue
        pre = sorted((s for s in spans if s["name"] == "prefill"),
                     key=lambda s: s["ts"])
        total = sum(int(s["attrs"].get("tokens", 0)) for s in pre)
        off = r["prompt_len"] - total
        for sp in pre:
            n = int(sp["attrs"].get("tokens", 0))
            out.append((sp["ts"], sp["ts"] + sp["dur"], off, n,
                        sp["attrs"].get("path", "direct")))
            off += n
    return out


def share(a: float, b: float, t0: float, t1: float) -> float:
    """The part of [a, b] inside [t0, t1] (a point counts whole)."""
    if b <= a:
        return 1.0 if t0 <= a <= t1 else 0.0
    return max(0.0, min(b, t1) - max(a, t0)) / (b - a)
