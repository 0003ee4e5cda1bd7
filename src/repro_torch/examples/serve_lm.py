"""Serving driver (thin wrapper over repro_torch.launch.serve), on the
card unless ``--device cpu`` is asked for:
clients -> thin-admission batcher -> continuous-batching engine server,
with latency percentiles. ``--mode lockstep`` runs the batch-at-a-time
baseline instead.

``--replicas N --routers M`` serves through the replicated fabric
instead: engine replicas register with a discovery Registry and
heartbeat load reports; routers dispatch each request to the
least-loaded replica and fail over when one dies. ``--kill-after N``
is the failover demo — one replica is killed after N requests have
been served (deterministically mid-run) and traffic keeps flowing on
its siblings. ``--rollout-after N`` is the zero-downtime rollout demo:
v0 and v1 are published into a versioned model store (``--store DIR``,
tempdir by default) and after N served requests a RolloutController
rolls the fleet v0 -> v1 one replica at a time (drain, hot-swap between
decode windows, health probe, canary) while requests keep completing.
``--full`` serves the architecture's full config instead of its reduced
one, and ``--page-size`` the paged KV cache:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --clients 3 \\
        --requests 4
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --full \\
        --page-size 16
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
        --replicas 2 --routers 1 --requests 6 --kill-after 4
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
