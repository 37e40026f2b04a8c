from .recorder import ConfigRecorder, Discarder
from .checkpoint import load, resume, save

__all__ = ["ConfigRecorder", "Discarder", "load", "resume", "save"]
