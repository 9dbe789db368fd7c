"""Runnable examples of the port, each a copy of the JAX package's example
of the same name over ``repro_torch``:

    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim
    PYTHONPATH=src python -m repro_torch.examples.sharded_campaign
"""
