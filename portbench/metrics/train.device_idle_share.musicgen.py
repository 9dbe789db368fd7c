"""train.device_idle_share.musicgen: 1 - (union of the device's activity) / the
traced segment's time, in %, over the traced training steps."""
from portbench.core.readers import idle_share as read  # noqa: F401
