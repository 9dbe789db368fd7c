"""The Phoenix Cloud control plane: the port's own copy of ``repro.core``
(framework-free Python, the same logic), so its traces match byte for byte."""
