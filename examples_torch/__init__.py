"""The five BASELINE configurations of ``examples/`` on ``qinfer_tpu_torch``,
one twin a file under the same name. Run from the repo's root:

    python -m examples_torch.config1_precession_quickstart [--cpu]
    python -m examples_torch.config5_adaptive_tomography --sharded [--cpu K]

On the card by default; ``--cpu`` runs on the CPU.
"""
