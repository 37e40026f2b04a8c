from .binner import LogBinner
from .host import real_dtype, resolve_device

__all__ = ["LogBinner", "real_dtype", "resolve_device"]
