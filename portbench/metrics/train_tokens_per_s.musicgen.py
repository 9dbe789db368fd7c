"""train_tokens_per_s.musicgen: every token of the steps completed in the window
over the window's whole time (host clock, the last step synchronised), in
the musicgen training cells."""
from portbench.core.readers import train_rate as read  # noqa: F401
