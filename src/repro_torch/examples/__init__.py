"""Runnable examples of the port, each a copy of the JAX package's example
of the same name over ``repro_torch``:

    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim
    PYTHONPATH=src python -m repro_torch.examples.sharded_campaign
    PYTHONPATH=src python -m repro_torch.examples.elastic_train
    PYTHONPATH=src python -m repro_torch.examples.elastic_serving
    PYTHONPATH=src python -m repro_torch.examples.multi_department_runtime
    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.train_100m

The three runtime examples take every card by default; ``--device cpu
--devices N`` runs them on N CPU ranks in place of the JAX examples'
forced host devices.
"""
