"""Whether what the timed path produced is correct: the comparisons with
the plain reference, each number beside its limit (``limits/<cell>.json``:
``{"<number>": {"limit": x, ...}}`` and the sample's size under
``sample``)."""

from __future__ import annotations

import numpy as np


def _limits(cell) -> dict:
    return {k: v for k, v in cell.limits.items() if k != "sample"}


def verdict(cell, numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits name: correct when each is at or under its limit. A
    named number that the run did not produce fails."""
    out, ok = {}, True
    for name, lim in _limits(cell).items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": lim["limit"]}
        if value is None or not (value <= lim["limit"]):
            ok = False
    return ok, out


def _gap_readings(prefix: str, gaps: list) -> dict:
    """The widest gap, how the gaps of all sampled tokens spread, and the
    largest of the requests' mean gaps (a fault in one request shows
    there undiluted by the others)."""
    g = np.concatenate(gaps) if gaps else np.zeros(1)
    per_request = [float(x.mean()) for x in gaps if len(x)] or [0.0]
    return {f"{prefix}max_logit_gap": float(g.max()),
            f"{prefix}mean_logit_gap": float(g.mean()),
            f"{prefix}max_request_mean_logit_gap": max(per_request),
            f"{prefix}p99_logit_gap": float(np.percentile(g, 99)),
            f"{prefix}share_gap_over_0.1": float((g > 0.1).mean())}


def pick_sample(requests: list, seed: int, size: int) -> list:
    """``size`` requests drawn from the seed, the one that served the
    most tokens among them."""
    if not requests:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 5])
    longest = max(range(len(requests)),
                  key=lambda i: (requests[i]["out_len"], -i))
    rest = [int(i) for i in rng.permutation(len(requests)) if i != longest]
    return [requests[i] for i in [longest] + rest[:size - 1]]


def serve_numbers(bundle, aux: dict, cell, seed: int, device,
                  control: bool = False) -> dict:
    """Requests lost, replies malformed, and the widest gap by which a
    served token's reference logit lies below the reference's best, over
    a sample of the requests that the window finished."""
    judged = bundle.ended_in_window()
    lost = sum(1 for r in judged if not r["ok"])
    done = [r for r in judged if r["ok"]]
    bad = sum(1 for r in done
              if r["out_len"] != r["max_new"]
              or not np.array_equal(r["reply"][:r["prompt_len"]],
                                    r["prompt"]))
    sample = pick_sample([r for r in done if r["out_len"] == r["max_new"]],
                         seed, int(cell.limits["sample"]["requests"]))
    seqs = [(r["reply"], r["prompt_len"]) for r in sample]
    chunk = bundle.config["serve"].get("prefill_chunk")
    reference = bundle.arch.reference
    gaps = reference.served_gaps(aux["sizes"], aux["weights"], seqs, chunk,
                                 device) if seqs else []
    out = {"lost_requests": lost, "bad_replies": bad,
           "_sampled_tokens": int(sum(len(g) for g in gaps))}
    out.update(_gap_readings("", gaps))
    if control and seqs:
        low = reference.control_gaps(aux["sizes"], aux["weights"], seqs,
                                     chunk, device)
        out.update(_gap_readings("_control_", low))
    return out


def _worst_leaf(prog: list, ref: list, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = float(np.median([ref[i] for i in idx]))
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx)


def _train_compare(losses, grad_norms, changes, ref, d_ref, keep) -> dict:
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref["losses"])),
            "grad_norm_gap": _worst_leaf(grad_norms,
                                         ref["first_grad_norms"]),
            "update_norm_gap": _worst_leaf(changes, d_ref, keep)}


def _ref_run(arch, s, seed, device, dt, batches, aux, quant=None):
    """The reference's three steps from the seed: (readings, changes)."""
    from perfbench import weights as wts

    start = wts.draw(arch.layout(s), seed, device, dt)
    params = wts.draw(arch.layout(s), seed, device, dt)
    ref = arch.reference.train_steps(s, params, batches, aux["optimizer"],
                                     aux["num_micro"], wts.leaves,
                                     quant=quant)
    changes = [float((pr - p0).norm()) for (_, p0), (_, pr) in
               zip(wts.leaves(start), wts.leaves(params))]
    return ref, changes


def train_numbers(bundle, aux: dict, cell, seed: int, device,
                  control: bool = False) -> dict:
    """The first three steps against the reference's: each step's loss,
    the first gradient as the optimizer got it (its norm, leaf by leaf),
    and each leaf's change over the three steps. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by rounding
    alone and are left out of the change."""
    import torch

    from perfbench import weights as wts

    probe, s, arch = aux["probe"], aux["sizes"], bundle.arch
    dt = getattr(torch, s["param_dtype"])
    batches = [torch.as_tensor(b, device=device) for b in probe.batches]
    start = wts.draw(arch.layout(s), seed, device, dt)
    ref_params = wts.draw(arch.layout(s), seed, device, dt)
    ref = arch.reference.train_steps(s, ref_params, batches,
                                     aux["optimizer"], aux["num_micro"],
                                     wts.leaves)
    g_ref = ref["first_grad_norms"]
    med_g = float(np.median(g_ref))
    keep = [g >= 1e-3 * med_g for g in g_ref]
    d_prog, d_ref = [], []
    for (_, p0), (_, pr), p3 in zip(wts.leaves(start), wts.leaves(ref_params),
                                    probe.params_after):
        d_prog.append(float((p3.to(p0.device) - p0).norm()))
        d_ref.append(float((pr - p0).norm()))
    del start, ref_params
    out = _train_compare(probe.losses, probe.first_grad_norms, d_prog, ref,
                         d_ref, keep)
    out["_left_out_leaves"] = int(len(keep) - sum(keep))
    if control:
        low, d_low = _ref_run(arch, s, seed, device, dt, batches, aux,
                              "fp8")
        for k, v in _train_compare(low["losses"], low["first_grad_norms"],
                                   d_low, ref, d_ref, keep).items():
            out[f"_control_{k}"] = v
        del low
        half = [b[: b.shape[0] // 2] for b in batches]
        aux_half = dict(aux, num_micro=1)
        hf, d_hf = _ref_run(arch, s, seed, device, dt, half, aux_half)
        for k, v in _train_compare(hf["losses"], hf["first_grad_norms"],
                                   d_hf, ref, d_ref, keep).items():
            out[f"_half_batch_{k}"] = v
    return out
