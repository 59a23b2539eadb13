"""Debug printing and file helpers, timers and the numpy oracle (port of
``bitmagic_tpu/utils``)."""
from . import debug, golden, timer

__all__ = ["debug", "golden", "timer"]
