from .binner import LogBinner
from .compare import absdiff, compare, effreldiff, reldiff
from .host import real_dtype, resolve_device
from .timing import (disable_benchmarks, enable_benchmarks, print_timer,
                     reset_timer, timer)

__all__ = ["LogBinner", "absdiff", "compare", "disable_benchmarks",
           "effreldiff", "enable_benchmarks", "print_timer", "real_dtype",
           "reldiff", "reset_timer", "resolve_device", "timer"]
