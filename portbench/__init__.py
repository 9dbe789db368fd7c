"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by ``run.py``.

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``cells/<cell>.json``,
``metrics/<metric>.py`` and ``kernels/<kernel>.py``. ``core/`` holds the
general code: the traffic generator, the training driver, the trace reader, the
frozen work formulas and peaks. ``reference/`` holds the plain float32
models that decide ``correct``; they import nothing of the program.
"""
