"""Offline endpointing (numpy): silence removal and noise harvesting."""
from .endpointing import FailToProcess, SignalSeparation

__all__ = ["FailToProcess", "SignalSeparation"]
