"""train.peak_gb.musicgen: ``torch.cuda.max_memory_allocated()`` over the window, GB."""
from portbench.core.readers import peak_gb as read  # noqa: F401
