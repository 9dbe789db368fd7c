"""The benchmark's general code (see ``portbench/__init__.py``)."""
