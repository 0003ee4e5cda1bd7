"""End-to-end LM training driver (thin wrapper over
repro_torch.launch.train).

Default: a tiny LM for 200 steps on the card (``--device cpu`` on the
CPU). The same program scales: ``--preset lm100m`` is the
~100M-parameter configuration, any assigned architecture runs via
``--arch <id> --reduced``, and ``--mesh 1,1`` places the learners' state
on a DeviceMesh.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset lm100m \
        --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --mesh 1,1 --steps 12
"""

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
