"""Block library of the port; importing it populates the global registry."""

from . import (basic, channelizer, filter, fourier, ldpc, math,  # noqa: F401
               sdr, testing)
