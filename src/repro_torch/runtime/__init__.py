"""Runtime: device pool, serving replicas, the elastic trainer and the
orchestrator that drives them under the provision service's policies."""
