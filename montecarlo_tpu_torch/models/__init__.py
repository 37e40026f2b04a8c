from .base import Model
from .hubbard import HubbardModel, HubbardModelAttractive, HubbardModelRepulsive

__all__ = ["Model", "HubbardModel", "HubbardModelAttractive",
           "HubbardModelRepulsive"]
