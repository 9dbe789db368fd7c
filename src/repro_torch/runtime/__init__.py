"""Runtime: device pool and serving replicas."""
