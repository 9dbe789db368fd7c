"""Cost tooling of the port: the per-rank counter (``analysis``), the
kernels' work formulas (``kernels``) and the roofline (``roofline``), which
``launch.dryrun`` puts together for each (arch x shape x mesh) cell."""
