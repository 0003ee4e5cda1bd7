"""Can two processes on one CUDA card form a ``cuda:gloo,cpu:gloo``
process group that runs the collectives a DTensor train step needs?

Each case runs in a fresh pair of interpreters on ``cuda:0`` that meet
at a ``file://`` rendezvous, so that a crash is the case's own: the c10d
collectives (``broadcast``, ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``), their functional forms (what DTensor calls),
a sharded matmul gathered with ``full_tensor``, and the step's first
collective, an FSDP weight gathered from ``Shard(0)`` to ``Replicate``
with autograd, then its backward, from the main thread and from another.
Prints one JSON line: each case's result on each rank ("ok", "wrong",
the error, or the exit code of a rank that crashed).

    PYTHONPATH=src python3 scripts/torch_probe_gloo_cuda.py
"""

import json
import os
import subprocess
import sys
import tempfile

RANK = r"""
import datetime, json, sys, threading
import torch
import torch.distributed as dist
rdv, rank, case = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("cuda:gloo,cpu:gloo", init_method=f"file://{rdv}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
dev = torch.device("cuda", 0)


def bcast():
    x = torch.full((4,), float(rank), device=dev)
    dist.broadcast(x, 0)
    return bool((x == 0).all())


def allreduce():
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    return bool((x == 3).all())


def allgather():
    x = torch.full((4,), float(rank), device=dev)
    y = torch.empty(8, device=dev)
    dist.all_gather_into_tensor(y, x)
    return bool((y[:4] == 0).all() and (y[4:] == 1).all())


def reduce_scatter():
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(y, x)
    return bool((y == 2 * x[4 * rank: 4 * rank + 4]).all())


def funcol():
    import torch.distributed._functional_collectives as fc
    g = dist.group.WORLD
    x = torch.full((4, 3), float(rank), device=dev)
    y = fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
    z = fc.wait_tensor(fc.reduce_scatter_tensor(
        torch.ones(8, 3, device=dev), "sum", 0, g))
    w = fc.wait_tensor(fc.all_reduce(x, "sum", g))
    return bool((y[4:] == 1).all() and (z == 2).all() and (w == 1).all())


def _mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (2,), mesh_dim_names=("data",))


def dtensor_matmul():
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = _mesh()
    g = torch.Generator().manual_seed(0)
    a = torch.randn(16, 32, generator=g).to(dev)
    w = torch.randn(32, 8, generator=g).to(dev)
    wd = distribute_tensor(w, mesh, [Shard(0)], src_data_rank=None)
    ad = distribute_tensor(a, mesh, [Shard(1)], src_data_rank=None)
    got = (ad @ wd).full_tensor()
    return bool(torch.allclose(got, a @ w, rtol=1e-4, atol=1e-4))


def fsdp_gather():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh()
    g = torch.Generator().manual_seed(0)
    w = torch.randn(512, 128, generator=g).to(dev)
    wd = distribute_tensor(w, mesh, [Shard(0)], src_data_rank=None)
    wd.requires_grad_()
    full = wd.redistribute(mesh, [Replicate()])
    full.sum().backward()
    return bool(torch.equal(full.to_local(), w)) and wd.grad is not None


def fsdp_gather_thread():
    box = {}
    t = threading.Thread(target=lambda: box.update(ok=fsdp_gather()))
    t.start()
    t.join()
    return box.get("ok", False)


CASES = {"broadcast": bcast, "all_reduce": allreduce,
         "all_gather_into_tensor": allgather,
         "reduce_scatter_tensor": reduce_scatter, "functional": funcol,
         "dtensor_matmul": dtensor_matmul, "fsdp_gather": fsdp_gather,
         "fsdp_gather_thread": fsdp_gather_thread}
try:
    out = "ok" if CASES[case]() else "wrong"
except Exception as exc:  # noqa: BLE001 - the probe records every error
    out = f"{type(exc).__name__}: {str(exc)[:300]}"
torch.cuda.synchronize()
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""
CASES = ("broadcast", "all_reduce", "all_gather_into_tensor",
         "reduce_scatter_tensor", "functional", "dtensor_matmul",
         "fsdp_gather", "fsdp_gather_thread")


def run_case(case: str) -> list:
    rdv = os.path.join(tempfile.mkdtemp(), "rdv")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, rdv, str(r), case],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    ranks = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        lines = out.strip().splitlines()
        ranks.append(json.loads(lines[-1]) if lines and p.returncode == 0
                     else f"exit {p.returncode}: {err.strip()[-300:]}")
    return ranks


def main() -> int:
    import torch
    results = {case: run_case(case) for case in CASES}
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "cuda_gloo_two_ranks_one_card": all(
            r == "ok" for ranks in results.values() for r in ranks),
        "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
